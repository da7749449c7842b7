#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (the port's quickest proof
that it still starts, builds and computes the right bits on the card).

    python3 chip_smoke.py

Phases, each of which raises on failure:

1. Device: the card's name, count and ``nvidia-smi`` name/power limit.
   Exits non-zero without a CUDA device.
2. Build every CUDA kernel of the main paths from ``src/repro_torch/kernels/
   csrc`` (nine sources, one ``nvcc`` each, in parallel) and print the
   build time and ``ptxas`` resource lines (by instance for the kernels
   redesigned for Hopper: flash_attention, fxp_svm_model, fxp_mlp_model,
   fxp_mlp_fleet, fxp_svm_fleet, fxp_layer, fxp_qmatmul and
   tree_ensemble), and, where the toolkit's ``cuobjdump`` exists, the count
   of tensor-core MMA instructions in the SASS: HMMA in each
   flash_attention instance, IMMA in each MLP megakernel instance and in
   each instance of the integer tile (fxp_qmatmul, fxp_layer's wide route;
   a bf16 flash instance without HMMA, or an 8- or 16-bit MLP instance or
   a tile instance without IMMA, fails).  Then the data: D6 ("har") and
   D5 ("pendigits") from their seeds, and the D6 tree trained by the port's
   CART (``max_depth=12``).
3. Each kernel against its plain PyTorch version on the card, bit for bit,
   at the main paths' shapes, every container width, values at qmin/qmax,
   int32-wrapping sums and batches 1..65536:
   * ``fxp_layer`` (561x64, 64x6, 561x6 layers, every activation, shifts 0
     and width-1) and ``fxp_mlp_model`` (561->64->6);
   * ``fxp_layer``'s narrow route: N in {1, 6, 10, 31, 32, 33} x K in
     {1, 8, 300, 561} at every activation, batches 1..65536, A a row slice
     (not 16-byte aligned), and at N 6 and 32 the largest K whose weights
     fit the narrow route beside the first K past it (the wide route); at
     least one case's int32 dot must wrap;
   * the MLP megakernels' tensor-core body at every container width: K not
     a multiple of 32 (561, 8, 33), N not a multiple of 8 (6, 10), widths
     at the routing predicate's limit (weights streamed), 8 layers, batches
     1..65536 around the 16-row tile, fleets of 2 and 8 whose slices start
     off a 16-byte boundary (M 3089, K 561), a logistic fleet (561 -> 6),
     full-range and edge values; at least one case's int32 dot must wrap;
   * ``fxp_qmatmul`` on the int8 tensor-core tile, at every container
     width: M in {1, 7, 64, 3089, 65536} x K in {8, 33, 561} x N in {6,
     300, 301}, the regimes in turn (all three at M 7), A a row slice every
     other case; K 40000 with full-range values (an s32 partial wraps); at
     least one case's int32 dot must wrap at 16 and at 32 bits;
   * ``fxp_layer``'s wide route (the same tile) at 561x64 on row slices of
     A that are not 16-byte aligned, M 7, 3089 and 65536;
   * ``fxp_svm_model``: poly and rbf at the D6 shapes (S=300, F=561, C=6)
     and the D5 shapes (S=300, F=8, C=10), nonzero random q(gamma) and
     q(coef0), degrees 1-3; and the cluster's split of the support vectors
     at S in {1, 31, 33, 300, 1696} (1696: the fit predicate's limit) x
     batches {1, 31, 3089, 65536};
   * ``tree_ensemble``: the trained D6 tree on float rows with NaN and
     +-inf values, and on int8, int16 and int32 containers (int32 rows in
     [2^24, 2^31), where the cast rounds, among them), batches 1..65536,
     with the node table in shared memory and, the budget lowered to 0
     nodes, in device memory;
   * ``fxp_mlp_fleet``: E in {2, 8} stacked 561->64->6 MLPs, one schedule
     for all and one per model, ragged and full batches, and full-range
     values whose int32 sums wrap;
   * ``fxp_svm_fleet``: poly and rbf, E = 2 (D6 shapes) and E = 4 (D5
     shapes, 3298 rows), each model its own formats, q(gamma), q(coef0)
     and degree; on the cluster body, E in {1, 2, 4, 8} x S in {1, 31, 33,
     300, 1696} x batches {1, 31, 3298, 65536} (D6 width where the plain
     version is cheap, D5 width elsewhere), and each slot of an E = 4
     launch at path D's shape against ``fxp_svm_model`` of that model;
   * ``pwl_activation``: the four variants on random values and on +-0,
     +-inf, NaN, subnormals and the segment edges 1.0, 2.375 and 5.0, on
     the (3089, 64) hidden layer, ragged shapes and an unaligned tensor, in
     float32, float16 and bfloat16 (bit for bit in each); with the fused
     bias (-0, +-inf and NaN among its values) at widths 1, 6, 7, 33, 64,
     561 and 4864 that cross the kernel's 16-byte vectors, rows 1..65536
     (4864: 1, 4 and 8192) and an unaligned view; and ``silu_pwl4`` at
     path E's decode (4, 4864) and bf16 prefill (8192, 4864) gate shapes;
   * ``flash_attention`` (not bit for bit: the two sum in other orders):
     float32 within 2e-5 and bfloat16 within 3e-2 of its plain version
     (scores materialized in float32, full float32 products), and in
     bfloat16 also every output row within 4e-2 of the row's largest
     |value| (at S 2048 a row averages ~2000 keys and is ~20x smaller than
     3e-2 allows for); causal and full, dh 32/64/128, S in {1, 7, 63, 64,
     65, 129, 2048}, BH 1 and BH 56 (4 x 14 heads) with K/V of 56 rows
     (G 1) and of 8 rows (G 7, the grouped form path E launches); head dims
     56, 80 and 112 (zero-padded to the next instance) in float32, bf16 and
     float16, and float16 at dh 64 (the float32 instance, rounded once:
     within 2^-8, one float16 ulp below 8).  Two
     controls at (56, 2048, 64) bf16 causal G 7, printed beside the
     kernel's readings: the plain version with P rounded to bf16 (what the
     kernel does) must pass both bounds, and with one key tile dropped from
     the last 64 rows must fail the row bound.
4. The main paths, each with every launch count set to 0 just before it
   and read just after it:
   A. a seeded 561->64->6 MLP and a 561x6 logistic model on D6, compiled
      for ``backend="cuda"`` at fxp32, fxp16, fxp16_pwl4, auto16 and auto8
      (auto* calibrated on 256 train rows); ``predict`` on the 3089-row
      test split and the batch ladder 1..64.  Every MLP predict is one
      megakernel launch, every logistic predict one fxp_layer launch; the
      forced per-layer route (``REPRO_MEGAKERNEL_VMEM=0``) gives the same
      labels with two fxp_layer launches; ``flt`` runs too.
   B. the D6 tree, a D6 svm-linear (561x6), D6 svm-poly (degree 2, coef0
      1.0) and svm-rbf with 300 prototypes and gamma = 1/(F var(x)), and
      the same two kernel SVMs on D5 (300x8x10), duals fitted by float64
      least squares on 2000 train rows.  Tree and svm-linear at the five
      tags and ``flt``, kernel SVMs at fxp32, fxp16, auto16 and auto8.  One
      tree_ensemble launch per tree predict, one fxp_svm_model launch per
      kernel-SVM predict (the megakernel route), one fxp_layer launch per
      quantized svm-linear predict; the forced per-layer SVM route gives the
      same labels with one fxp_qmatmul and one fxp_layer launch.
   F. (after B) C emission: every quantized artifact of A and B emits
      its freestanding fixed-point C, built by the host's C compiler (in
      parallel) and replayed on the test rows; its labels must equal the
      ``cuda`` artifact's on every row.  The measured C sections are
      printed beside the artifact's flash and SRAM model.
   C. the flt D6 MLP with a pwl2, pwl4 or rational sigmoid on ``cuda``:
      one pwl_activation launch per predict (the hidden layer's bias added
      in it), labels equal to the plain route's (the same model on
      ``ref``) on every row whose float64 top-2 gap is at least 1e-4.
   D. the serving plane: one ``InferenceService`` on the card hosting 8 D6
      MLPs (auto16, each calibrated on its own 2000 train rows), 2 D6
      logistic models (fxp16), 4 D5 rbf SVMs (fxp32) and the D6 tree
      (fxp16).  ``enable_fleet()`` must form exactly three fleets; 6 client
      threads send 360 requests of 1-64 rows, and every response must equal
      its member's own ``predict``.  Each fleet stacks at least once, none
      falls back, fxp_mlp_fleet and fxp_svm_fleet launch, and the tree is
      served by its own worker.
   E. the dense LM stack: qwen2-0.5b at its published widths with seeded
      weights.  A bf16 prefill (batch 4 x 2048 tokens) makes exactly 24
      flash_attention launches, one per layer, each on the 2 KV heads (G 7,
      K/V not repeated); with the weights in float32
      its logits are within 1e-4 (relative) of the same forward with the
      attention through the materialized-scores oracle, and in bf16 no
      further from the float32 logits than 1.5x the oracle route; in
      float32, decode over the KV cache matches the forward within 2e-3
      (batch 2, 12 steps); an
      ``InferenceService`` serves it at ``flt`` and at fxp8/qnm with an
      int8 KV cache and the pwl4 gate, ``generate`` (batch 4, 32 tokens)
      launches no flash_attention, and its tokens are serve_step's argmax;
      at the pwl4 gate every layer's gate is one pwl_activation launch
      (silu_pwl4) per step and per forward, and the artifact's logits
      through that route are within 1e-4 of the op-by-op gate's in float32
      and, in bf16, no further from the float32 logits than 1.5x the
      op-by-op gate.
   G. the paper's pipeline on D6 at full width (after E): ``train_mlp``
      (561->64->6), ``train_logistic``, ``train_linear_svm`` and
      ``train_kernel_svm`` (rbf and poly, 400 prototypes) train on the card
      (seconds and flt test accuracy printed); each, with main()'s CART
      tree, must beat chance (1/6) by 0.5 in flt test accuracy, and the
      trained MLP must beat path A's untrained one.  Each model is compiled
      at fxp16 and auto8 on ``cuda`` and saved with its C (``include_c``)
      into the git-ignored ``build/pipeline/``; each archive is loaded on
      the card (load time printed), its labels on the 3089 test rows equal
      the saved artifact's bit for bit, one launch of its kernel
      (fxp_mlp_model, fxp_layer, fxp_svm_model or tree_ensemble) per
      predict, and the carried C equals ``emit_c()``.  A fresh
      ``InferenceService`` hosts the 12 loaded archives behind
      ``serve_http`` on 127.0.0.1; 8 client threads send every test row of
      every endpoint in requests of 1, 16 and 256 rows in turns, and every
      HTTP label must equal the in-process label; ``/v1/health`` and
      ``/v1/stats`` must answer; requests/s and p50/p99 are printed beside
      the same requests in process.  An archive with one byte flipped must
      raise ``ArtifactIntegrityError``.
   In A, B and D, labels equal the plain versions' on the card (in D, each
   member's own predict); in A and B the rows where ``ref`` and ``cuda``
   differ are printed as information.
5. Timing with CUDA events after warm-up: flash_attention at the prefill's
   shape (BH 56, S 2048, dh 64, bf16 causal), with K/V of 8 rows (G 7, as
   path E launches it) and of 56, beside its plain version, its bound and
   ``scaled_dot_product_attention`` (the library yardstick, with
   ``enable_gqa`` for the grouped form), the
   prefill forward and the kernel's share of it, decode ms/token at both
   served targets; each recorded kernel's device time from a
   torch.profiler trace besides (below ~0.04 ms the CUDA-event loop
   measures the host's launch cost), and fxp_svm_model's at fxp16 rbf
   at every timed batch, fxp_layer's at the logistic head (fxp16, 3089 and
   65536 rows), at the SVM per-layer route's decision stage (3089 x 300
   x 6 and 65536 rows) and on its wide route at the per-layer MLP's first
   layer (561 x 64, fxp16, auto8 and fxp32), fxp_qmatmul's and
   tree_ensemble's at 3089 and 65536 rows (the tree on the container the
   lowering passes it); each kernel and its plain version
   at batches 1, 64, 3089 and 65536 (the fleet kernels at 3089 or 3298 and
   65536, fxp_svm_fleet also at a 64-row serving round, beside eight
   fxp_mlp_model and four fxp_svm_model launches), beside the bound;
   ``predict`` end to end and by stage (pageable and pinned rows); the
   host time of ``FleetStack.predict_device`` beside the time until the
   card is done (equal times would mean a hidden synchronization); the
   device activities of one fxp16 tree predict beside the route of the
   first tree lowering (a float32 cast before the kernel); and the
   first serving record: 8 D6 MLP endpoints, 8 client threads each sending
   500 one-row requests one at a time, fleet off and on.  pwl_activation's
   record is path C's hidden layer with the fused bias (beside the unfused
   pair); path E's pwl4 gate is timed at its decode and prefill shapes
   beside the op-by-op gate, a bf16 prefill forward at the pwl4 gate and
   one fxp8/qnm/int8-KV/pwl4 decode step are profiled with the gate
   through the kernel and op by op (launches, device activities, the
   kernel's device time a layer against its bytes bound), decode ms/token
   of that artifact is taken with the two routes in turns, and path C's
   predict is profiled (device time by kernel, activities, launches)
   beside its lowering with the bias added outside the kernel at 1, 64,
   3089 and 65536 rows.

The lines before the last are a JSON ``{"kernels": [...]}`` record and the
``nvidia-smi`` name/power-limit line; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import threading
import time
import types

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
INT8_TENSOR_OPS_PER_S = 1979e12  # dense int8 tensor-core rate (data sheet)
FP32_OPS_PER_S = 67e12  # float32 outside the tensor cores (data sheet)
BF16_TENSOR_OPS_PER_S = 989.4e12  # dense bf16 tensor-core rate (data sheet)
INT32_LANES_PER_SM = 64  # Hopper SM: 64 INT32 lanes, one IMAD (2 ops) each
TAGS = {
    "fxp32": dict(number_format="fxp32"),
    "fxp16": dict(number_format="fxp16"),
    "fxp16_pwl4": dict(number_format="fxp16", sigmoid="pwl4"),
    "auto16": dict(number_format="auto16"),
    "auto8": dict(number_format="auto8"),
}
TREE_TAGS = tuple(TAGS) + ("flt",)  # tree and svm-linear
SVM_TAGS = ("fxp32", "fxp16", "auto16", "auto8")  # kernel SVMs
BATCHES = (1, 7, 64, 3089, 65536)
TIMED_BATCHES = (1, 64, 3089, 65536)
LADDER = (1, 2, 4, 8, 16, 32, 64)
N_CALIBRATION = 256
N_PROTOTYPES = 300
N_FIT_ROWS = 2000
TREE_DEPTH = 12  # benchmarks/common.py:40
FLASH_LENGTHS = (1, 7, 63, 64, 65, 129, 2048)  # around the 64-wide tiles
# pwl_activation's fused bias: widths that cross the 4- and 8-value
# vectors of its 16-byte loads (1, D5-like 6 and 7, 33), path C's hidden
# layer (64), D6's 561 and qwen2-0.5b's d_ff (4864, at the LM's rows), at
# batches 1..65536
PWL_BIAS_COLS = (1, 6, 7, 33, 64, 561, 4864)
PWL_BIAS_ROWS = (1, 7, 3089, 65536)
# (BH, group G): one head, and qwen2-0.5b's 14 heads x batch 4, ungrouped
# and with its 2 KV heads (G = 7, as path E launches it)
FLASH_HEADS = ((1, 1), (56, 1), (56, 7))
# bf16 flash_attention against its plain version: max abs error, and max
# over rows of (max |error| in the row) / (max |value| in the row); see
# PERF.md (Findings) for the readings that set the row bound
FLASH_BF16_ATOL, FLASH_BF16_ROW_RTOL = 3e-2, 4e-2
# float16 flash_attention runs the float32 instance and rounds its output
# once to float16: one float16 ulp of an output below 8 in magnitude
FLASH_FP16_ATOL = 2.0 ** -8
# head dims between the kernel's instances (deepseek-v3 56, hubert 80,
# zamba2 112): zero-padded to the next instance by the wrapper
FLASH_PADDED_DIMS = (56, 80, 112)
SVM_LENGTHS = (1, 31, 33, 300, 1696)  # 1696: the fit predicate's limit
SVM_BATCHES = (1, 31, 3089, 65536)
SVM_FLEET_SIZES = (1, 2, 4, 8)
SVM_FLEET_BATCHES = (1, 31, 3298, 65536)  # 3298: the D5 test split
# fxp_layer around its narrow route (N <= 32): N at 1, the main paths' 6
# and 10 classes, and the bucket edges; K at 1, D5's 8, the SVM decision
# stage's 300 and D6's 561; batches 1..65536
LAYER_NS = (1, 6, 10, 31, 32, 33)
LAYER_KS = (1, 8, 300, 561)
LAYER_BATCHES = (1, 7, 31, 64, 3089, 65536)
# fxp_qmatmul on the int8 tensor-core tile (csrc/fxp_tile.cuh): K at D5's
# 8, one past a k32 step and D6's 561; N at the 6 classes, the 300
# prototypes and one past them
QMATMUL_KS = (8, 33, 561)
QMATMUL_NS = (6, 300, 301)
LM_ARCH = "qwen2-0.5b"  # src/repro_torch/configs/qwen2_0_5b.py, full width
LM_BATCH, LM_SEQ = 4, 2048  # the bf16 prefill
LM_DECODE_BATCH, LM_DECODE_STEPS = 2, 12  # the float32 decode-vs-forward check
LM_GEN_BATCH, LM_GEN_TOKENS = 4, 32  # generate on each served target
# the kernels redesigned for Hopper: their ptxas lines by instance
REDESIGNED = ("flash_attention", "fxp_svm_model", "fxp_mlp_model",
              "fxp_mlp_fleet", "fxp_svm_fleet", "fxp_layer", "fxp_qmatmul",
              "tree_ensemble")
# tensor-core MMA in the SASS: (library, instance name part, opcode); each
# instance whose name holds the part must issue the opcode
TENSOR_CORE_SASS = (("flash_attention", "bfloat16", "HMMA"),
                    ("fxp_mlp_model", "mma_kernel", "IMMA"),
                    ("fxp_mlp_fleet", "mma_kernel", "IMMA"),
                    ("fxp_qmatmul", "fxp_qmatmul_kernel", "IMMA"),
                    ("fxp_layer", "fxp_layer_kernel", "IMMA"))


def log(*args):
    print(*args, flush=True)


def row_rel_err(got, want):
    """Max over the rows of (max |got - want| in the row) / (max |want| in
    the row), in float32: an attention output's error against the row's own
    scale, which at S 2048 is ~20x below an absolute bound of 3e-2."""
    err = (got.float() - want.float()).abs().amax(-1)
    scale = want.float().abs().amax(-1).clamp_min(1e-30)
    return float((err / scale).max()) if err.numel() else 0.0


def attention_control(torch, q, k, v, p_bf16=False, drop=None):
    """Causal attention with float32 scores as the plain version computes
    it, changed in one way: ``p_bf16`` rounds the unnormalized p to bf16
    before P.V (l sums the float32 p), ``drop=(a, b, r)`` masks keys
    [a, b) from rows r.. (a fault that loses one key tile)."""
    s, dh = q.shape[1], q.shape[2]
    scale = float(np.float32(1.0 / math.sqrt(dh)))
    scores = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    pos = torch.arange(s, device=q.device)
    masked = pos[None, :] > pos[:, None]
    if drop is not None:
        a, b, r = drop
        masked = masked | ((pos[:, None] >= r) & (pos[None, :] >= a)
                           & (pos[None, :] < b))
    scores = scores.masked_fill(masked, -1e30)
    p = torch.exp(scores - scores.amax(-1, keepdim=True))
    del scores
    l = p.sum(-1, keepdim=True)
    if p_bf16:
        p = p.to(torch.bfloat16).float()
    return (torch.einsum("bqk,bkd->bqd", p, v.float()) / l).to(q.dtype)


def smi(query: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


class Device:
    """Phase 1: what we run on, and the peak rates the bounds use."""

    def __init__(self, torch):
        self.name = torch.cuda.get_device_name(0)
        self.count = torch.cuda.device_count()
        self.smi_line = smi("name,power.limit")
        self.sms = torch.cuda.get_device_properties(0).multi_processor_count
        self.max_sm_mhz = float(smi("clocks.max.sm").split()[0])
        self.int32_ops_per_s = (self.sms * INT32_LANES_PER_SM * 2
                                * self.max_sm_mhz * 1e6)
        log(f"device: {self.name} x{self.count}; nvidia-smi: {self.smi_line}")
        log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
            f"{self.sms} SMs, clocks.max.sm {self.max_sm_mhz:.0f} MHz")
        log(f"peaks used for bounds: HBM {HBM_BYTES_PER_S / 1e12} TB/s; int32 "
            f"CUDA cores {self.int32_ops_per_s / 1e12:.2f} Top/s "
            f"({self.sms} SMs x {INT32_LANES_PER_SM} lanes x 2 ops x "
            f"{self.max_sm_mhz:.0f} MHz); int8 tensor cores "
            f"{INT8_TENSOR_OPS_PER_S / 1e12:.0f} Top/s; float32 "
            f"{FP32_OPS_PER_S / 1e12:.0f} Tflop/s")

    def int_peak(self, bits: int) -> float:
        """Peak integer rate for a container width."""
        return INT8_TENSOR_OPS_PER_S if bits == 8 else self.int32_ops_per_s

    def mma_peak(self, bits: int) -> float:
        """Peak rate of a container width's products on the MLP
        megakernels' route: int8 tensor cores at 8 bits, four int8 MMAs per
        product at 16 bits (split bytes), the CUDA cores at 32 bits."""
        return {8: INT8_TENSOR_OPS_PER_S, 16: INT8_TENSOR_OPS_PER_S / 4,
                32: self.int32_ops_per_s}[bits]

    def tile_peak(self, bits: int) -> float:
        """Peak rate of a container width's products on the integer tile of
        fxp_qmatmul and fxp_layer's wide route: every width on the int8
        tensor cores, one, four or ten int8 MMAs a product (byte planes
        whose pairs i + j <= 3 survive mod 2^32)."""
        return INT8_TENSOR_OPS_PER_S / {8: 1, 16: 4, 32: 10}[bits]

    def bound(self, nbytes: int, ops: int, peak: float):
        """(bound_ms, bound_by): the larger of bytes over the memory rate and
        operations over the peak rate for the operand type."""
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / peak
        return (max(t_bytes, t_ops) * 1e3,
                "bytes" if t_bytes >= t_ops else "operations")


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


# --------------------------------------------------------------------------
# launch counts
# --------------------------------------------------------------------------
def reset_launches(K):
    for fn in K.launchers.values():
        fn.launches = 0


def launch_counts(K):
    return {name: fn.launches for name, fn in K.launchers.items()}


def expect_launches(K, before, want, what):
    """Fail unless the launches since ``before`` are exactly ``want``
    (kernels not named: none)."""
    now = launch_counts(K)
    got = {n: now[n] - before[n] for n in now}
    expected = {n: want.get(n, 0) for n in now}
    if got != expected:
        raise AssertionError(f"{what}: launches {got}, expected {expected}")


# --------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# --------------------------------------------------------------------------
def _ints(rng, shape, bits, regime):
    lo, hi = -(2 ** (bits - 1)), 2 ** (bits - 1) - 1
    if regime == "mid":
        mag = {8: 3, 16: 7, 32: 12}[bits]
        lo, hi = -(2 ** mag), 2 ** mag - 1
    v = rng.randint(lo, hi + 1, shape, dtype=np.int64)
    if regime == "edge":  # only the container's extremes and their neighbours
        v = np.choose(rng.randint(0, 5, shape), [lo, lo + 1, -1, hi - 1, hi])
    return v.astype({8: np.int8, 16: np.int16, 32: np.int32}[bits])


def _mid_shift(bits, k):
    """A shift that lands a 'mid' accumulator inside the container."""
    mag = {8: 3, 16: 7, 32: 12}[bits]
    return max(0, min(31, 2 * mag + math.ceil(math.log2(k)) // 2 - (bits - 4)))


def non_finite_rows(x, tree):
    """A copy of the float rows ``x`` whose first rows hold NaN and +-inf
    in the patterns the tree kernel must treat as the TPU kernel does."""
    x = np.array(x, np.float32)
    root, f = int(tree.feature[0]), x.shape[1]
    x[0, 5] = np.nan
    x[1, f - 1] = np.inf
    x[2, root] = -np.inf  # a single -inf: left exactly at its feature
    x[3, (root + 1) % f] = -np.inf
    x[4, [0, 2]] = -np.inf
    x[5, :] = np.inf
    x[6, root] = np.inf
    return x


def pwl_edges():
    """Values the PWL kernel must treat as the reference does: +-0, +-inf,
    NaN, subnormals and the smallest normal, the segment edges 1.0, 2.375
    and 5.0 with their float32 neighbours, and the float32 extremes."""
    f32 = np.finfo(np.float32)
    vals = [0.0, np.inf, np.nan, 1e-45, 1e-39, float(f32.tiny),
            float(f32.max)]
    for v in np.asarray([1.0, 2.375, 5.0], np.float32):
        vals += [v, np.nextafter(v, np.float32(0)),
                 np.nextafter(v, np.float32(9))]
    vals = np.asarray(vals, np.float32)
    return np.concatenate([vals, -vals])


class KernelCheck:
    """Phase 3: every comparison of a kernel with its plain version."""

    NAMES = ("fxp_layer", "fxp_mlp_model", "fxp_qmatmul", "fxp_svm_model",
             "tree_ensemble", "pwl_activation", "fxp_mlp_fleet",
             "fxp_svm_fleet", "flash_attention")

    def __init__(self, torch, K):
        self.torch, self.K = torch, K
        self.cases = {n: 0 for n in self.NAMES}
        self.max_abs_err = {n: 0 for n in self.NAMES}
        self.wrapped = 0  # SVM cases whose x . sv^T wrapped int32
        self.mlp_wrapped = 0  # MLP cases whose first int32 dot wrapped
        self.layer_wrapped = 0  # fxp_layer cases whose int32 dot wrapped
        self.layer_routes = {"narrow": 0, "tile": 0}
        # fxp_qmatmul cases whose int32 dot wrapped, by container width
        self.qmatmul_wrapped = {8: 0, 16: 0, 32: 0}
        self.tree_routes = {"smem": 0, "global": 0}
        self.pwl_bias_cases = 0  # pwl_activation cases with the fused bias
        self.flash_err = {}  # dtype -> max abs err of flash_attention
        self.flash_row_rel = 0.0  # bf16: max per-row relative error

    def _compare(self, name, got, want, what):
        torch = self.torch
        torch.cuda.synchronize()
        if got.dtype != want.dtype or got.shape != want.shape:
            raise AssertionError(f"{name} {what}: {got.dtype}{tuple(got.shape)}"
                                 f" vs plain {want.dtype}{tuple(want.shape)}")
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max()) \
            if got.numel() else 0
        self.max_abs_err[name] = max(self.max_abs_err[name], err)
        self.cases[name] += 1
        if err:
            bad = int((got != want).sum())
            raise AssertionError(f"{name} {what}: {bad} elements differ from "
                                 f"the plain version (max abs err {err})")

    def _compare_bits(self, name, got, want, what):
        """Float results: the same bits everywhere, float32, float16 or
        bfloat16 (the card's NaN is canonical in both); max_abs_err over the
        finite entries."""
        torch = self.torch
        torch.cuda.synchronize()
        if got.dtype != want.dtype or got.shape != want.shape:
            raise AssertionError(f"{name} {what}: {got.dtype}{tuple(got.shape)}"
                                 f" vs plain {want.dtype}{tuple(want.shape)}")
        both = torch.isfinite(got) & torch.isfinite(want)
        err = float((got[both].double() - want[both].double()).abs().max()) \
            if bool(both.any()) else 0.0
        self.max_abs_err[name] = max(self.max_abs_err[name], err)
        self.cases[name] += 1
        as_int = {4: torch.int32, 2: torch.int16}[got.element_size()]
        bad = int((got.view(as_int) != want.view(as_int)).sum())
        if bad:
            raise AssertionError(f"{name} {what}: {bad} elements differ from "
                                 f"the plain version in their bits (max abs "
                                 f"err {err})")

    def _compare_close(self, name, got, want, atol, what):
        """Float results that sum in another order: within ``atol``, every
        entry finite."""
        torch = self.torch
        torch.cuda.synchronize()
        if got.dtype != want.dtype or got.shape != want.shape:
            raise AssertionError(f"{name} {what}: {got.dtype}{tuple(got.shape)}"
                                 f" vs plain {want.dtype}{tuple(want.shape)}")
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{name} {what}: non-finite output")
        err = float((got.float() - want.float()).abs().max())
        self.max_abs_err[name] = max(self.max_abs_err[name], err)
        self.cases[name] += 1
        if err > atol:
            raise AssertionError(f"{name} {what}: max abs err {err} against "
                                 f"the plain version, over {atol}")
        return err

    def flash_case(self, gen, dtype, causal, dh, s, bh, group):
        """The kernel against its plain version (K/V repeated to the query
        heads, scores materialized in float32): atol 2e-5 in float32, 3e-2
        in bfloat16, the reference's bounds (tests/test_kernels.py), and in
        bfloat16 the per-row relative bound."""
        torch, fa = self.torch, self.K.fa
        q = torch.randn(bh, s, dh, generator=gen, device="cuda").to(dtype)
        k, v = (torch.randn(bh // group, s, dh, generator=gen, device="cuda")
                .to(dtype) for _ in range(2))
        got = fa.flash_attention_cuda(q, k, v, causal)
        want = fa.flash_attention_plain(q, k, v, causal)
        what = f"{dtype} causal={causal} (BH {bh}, S {s}, dh {dh}, G {group})"
        atol = {torch.float32: 2e-5, torch.bfloat16: FLASH_BF16_ATOL,
                torch.float16: FLASH_FP16_ATOL}[dtype]
        err = self._compare_close("flash_attention", got, want, atol, what)
        key = str(dtype).replace("torch.", "")
        self.flash_err[key] = max(self.flash_err.get(key, 0.0), err)
        if dtype == torch.bfloat16:
            rel = row_rel_err(got, want)
            self.flash_row_rel = max(self.flash_row_rel, rel)
            if rel > FLASH_BF16_ROW_RTOL:
                raise AssertionError(f"flash_attention {what}: a row's error "
                                     f"is {rel} of its largest value, over "
                                     f"{FLASH_BF16_ROW_RTOL}")

    def flash_controls(self, gen):
        """The bf16 bounds' controls at the prefill's shape (BH 56, S 2048,
        dh 64, causal, G 7): the plain version with P rounded to bf16 before
        P.V (l from the float32 p) must pass both bounds; with keys
        1920..1983 dropped from the rows that see key 1984 (the last query
        tile loses one key tile) it must fail the row bound."""
        torch, fa = self.torch, self.K.fa
        bh, s, dh, group = 56, 2048, 64, 7
        q = torch.randn(bh, s, dh, generator=gen, device="cuda").to(
            torch.bfloat16)
        k, v = (fa.expand_kv(torch.randn(bh // group, s, dh, generator=gen,
                                         device="cuda").to(torch.bfloat16),
                             group) for _ in range(2))
        want = fa.flash_attention_plain(q, k, v, True)
        readings = {}
        for name, kw in (("P bf16", dict(p_bf16=True)),
                         ("tile dropped", dict(drop=(1920, 1984, 1984)))):
            got = attention_control(torch, q, k, v, **kw)
            readings[name] = (float((got.float() - want.float()).abs().max()),
                              row_rel_err(got, want))
        abs_p, rel_p = readings["P bf16"]
        if abs_p > FLASH_BF16_ATOL or rel_p > FLASH_BF16_ROW_RTOL:
            raise AssertionError(f"flash_attention control: the plain version "
                                 f"with P in bf16 fails the bounds "
                                 f"({readings})")
        if readings["tile dropped"][1] <= FLASH_BF16_ROW_RTOL:
            raise AssertionError(f"flash_attention control: a dropped key "
                                 f"tile passes the row bound ({readings})")
        log(f"  flash_attention bf16 controls at (BH 56, S 2048, dh 64) "
            f"causal, G 7, (max abs err, max row relative err) against the "
            f"plain version: " + ", ".join(
                f"{n} ({a:.4e}, {r:.4e})" for n, (a, r) in readings.items()))

    def _cuda(self, *arrays):
        return [self.torch.from_numpy(a).cuda() for a in arrays]

    def pwl_case(self, rng, shape, variant, offset=0, dtype=None):
        """float32, or a narrow float (rounded from the same values): the
        kernel computes in float32 and rounds to nearest even on the store,
        as the plain version's cast does."""
        K = self.K
        n = int(np.prod(shape))
        flat = (rng.randn(n + offset) * 4).astype(np.float32)
        edges = pwl_edges()
        flat[offset:offset + min(n, edges.size)] = edges[:n]
        x, = self._cuda(flat)
        if dtype is not None:
            x = x.to(dtype)
        x = x[offset:].view(shape)  # offset 1: an unaligned tensor
        got = K.pwl.pwl_activation_cuda(x, variant)
        want = K.pwl.pwl_activation_plain(x, variant)
        self._compare_bits("pwl_activation", got, want,
                           f"{variant} {x.dtype} {shape} offset {offset}")

    def pwl_bias_case(self, rng, dtype, variant, rows, cols, offset=0):
        """The fused bias: ``variant(x + b)``, x (rows, cols) with the edges
        in its first values (a view ``offset`` values past a 16-byte
        boundary when offset > 0), b (cols,) with -0, +-inf and NaN first;
        bit for bit against the plain version's ``pwl(x + b)``."""
        K = self.K
        flat = (rng.randn(rows * cols + offset) * 4).astype(np.float32)
        edges = pwl_edges()
        flat[offset:offset + min(rows * cols, edges.size)] = \
            edges[:rows * cols]
        b = (rng.randn(cols) * 2).astype(np.float32)
        b[:4] = np.asarray([-0.0, np.inf, -np.inf, np.nan], np.float32)[:cols]
        x, b = self._cuda(flat, b)
        x = x.to(dtype)[offset:].view(rows, cols)
        b = b.to(dtype)
        got = K.pwl.pwl_activation_cuda(x, variant, bias=b)
        want = K.pwl.pwl_activation_plain(x, variant, bias=b)
        self._compare_bits("pwl_activation", got, want,
                           f"{variant} {x.dtype} ({rows}, {cols}) + bias "
                           f"offset {offset}")
        self.pwl_bias_cases += 1

    def pwl_cases(self, rng):
        """The four variants without a bias (random values and the edges,
        ragged shapes, an unaligned tensor), with the fused bias at widths
        that cross the 16-byte vectors (C 1..4864, rows 1..65536, an
        unaligned view), and silu_pwl4 at path E's gate shapes: decode (4,
        4864) and the bf16 prefill (4 x 2048, 4864)."""
        torch = self.torch
        for variant in self.K.pwl.PWL_VARIANTS:
            for dtype in (None, torch.float16, torch.bfloat16):
                for shape in ((3089, 64), (7, 13), (5, 3, 2)):
                    self.pwl_case(rng, shape, variant, dtype=dtype)
                self.pwl_case(rng, (4097,), variant, offset=1, dtype=dtype)
        for variant in self.K.pwl.PWL_VARIANTS:
            for dtype in (torch.float32, torch.float16, torch.bfloat16):
                for cols in PWL_BIAS_COLS:
                    rows_list = ((1, 4, LM_BATCH * LM_SEQ) if cols > 561
                                 else PWL_BIAS_ROWS)
                    for rows in rows_list:
                        self.pwl_bias_case(rng, dtype, variant, rows, cols)
                    self.pwl_bias_case(rng, dtype, variant, 7, cols, offset=1)
        d_ff = self.K.configs.get_config(LM_ARCH).d_ff
        for dtype in (None, torch.bfloat16):
            self.pwl_case(rng, (LM_GEN_BATCH, d_ff), "silu_pwl4",
                          dtype=dtype)
        self.pwl_case(rng, (LM_BATCH * LM_SEQ, d_ff), "silu_pwl4",
                      dtype=torch.bfloat16)

    def mlp_fleet_case(self, rng, bits, e, m, hetero, regime):
        K = self.K
        dims = (561, 64, 6)
        acts = K.layer.LAYER_ACTIVATIONS
        scheds = []
        for i in range(e):
            j = i if hetero else 0
            if regime == "mid":
                shifts = (_mid_shift(bits, 561) - j % 2,
                          _mid_shift(bits, 64) + j % 3)
                fracs = (bits - 6 - j % 2, bits - 6)
            else:  # full-range values: int32 sums wrap
                shifts, fracs = (bits - 1 - j % 2, 0), (bits - 1, j % 2)
            act = acts[1 + (j + bits) % (len(acts) - 1)]
            scheds.append(((shifts[0], K.fxp.FxpFormat(bits, fracs[0]), act),
                           (shifts[1], K.fxp.FxpFormat(bits, fracs[1]),
                            "none")))
        scheds = tuple(scheds)
        x, = self._cuda(_ints(rng, (e, m, dims[0]), bits, regime))
        ws = self._cuda(*[_ints(rng, (e, i, o), bits, regime)
                          for i, o in zip(dims, dims[1:])])
        bs = self._cuda(*[_ints(rng, (e, o), bits, "full") for o in dims[1:]])
        got = K.model.fxp_mlp_fleet_cuda(x, ws, bs, scheds)
        want = K.model.fxp_mlp_fleet_plain(x, ws, bs, scheds)
        self._compare("fxp_mlp_fleet", got, want,
                      f"w{bits} E={e} {m}x{dims} "
                      f"{'per-model' if hetero else 'uniform'} schedules "
                      f"{regime}")

    def _count_wrap(self, x, w):
        """Whether the first layer's exact dot over the first rows leaves
        int32 (float64 is exact below 2^53, so at 8 and 16 bits)."""
        torch = self.torch
        dot = x[:64].to(torch.float64) @ w.to(torch.float64)
        self.mlp_wrapped += int(dot.abs().max() >= 2 ** 31)

    def _mlp_schedule(self, bits, dims, regime, j):
        """A schedule for ``dims``: model j's shifts and formats vary with
        j; hidden layers take the activations in turn, the last none."""
        fxp, acts = self.K.fxp, self.K.layer.LAYER_ACTIVATIONS
        n, sched = len(dims) - 1, []
        for l in range(n):
            hidden = l < n - 1
            if regime == "mid":
                shift = max(0, _mid_shift(bits, dims[l]) - j % 2)
                frac = bits - 6 - (j % 2 if hidden else 0)
            elif regime == "full":  # full-range values: int32 sums wrap
                shift, frac = ((bits - 1 - j % 2, bits - 1) if hidden
                               else (0, j % 2))
            else:  # edge
                shift, frac = (0, bits - 1) if hidden else (bits - 1, 0)
            act = acts[(l + j + bits) % len(acts)] if hidden else "none"
            sched.append((min(shift, 31), fxp.FxpFormat(bits, frac), act))
        return tuple(sched)

    def mlp_shape_case(self, rng, bits, dims, m, e=0, hetero=False,
                       regime="mid"):
        """fxp_mlp_model (e = 0) or fxp_mlp_fleet of e models at any widths
        and depth, against the plain version; counts int32-wrapping dots."""
        K = self.K
        n_models = max(e, 1)
        scheds = tuple(self._mlp_schedule(bits, dims, regime,
                                          i if hetero else 0)
                       for i in range(n_models))
        x, = self._cuda(_ints(rng, (n_models, m, dims[0]), bits, regime))
        ws = self._cuda(*[_ints(rng, (n_models, i, o), bits, regime)
                          for i, o in zip(dims, dims[1:])])
        bs = self._cuda(*[_ints(rng, (n_models, o), bits, "full")
                          for o in dims[1:]])
        self._count_wrap(x[0], ws[0][0])
        what = (f"w{bits} {m}x{tuple(dims)} {regime}"
                + (f" E={e} {'per-model' if hetero else 'uniform'}"
                   if e else ""))
        if e:
            got = K.model.fxp_mlp_fleet_cuda(x, ws, bs, scheds)
            want = K.model.fxp_mlp_fleet_plain(x, ws, bs, scheds)
            self._compare("fxp_mlp_fleet", got, want, what)
        else:
            args = (x[0], [w[0] for w in ws], [b[0] for b in bs], scheds[0])
            got = K.model.fxp_mlp_model_cuda(*args)
            want = K.model.fxp_mlp_model_plain(*args)
            self._compare("fxp_mlp_model", got, want, what)

    def mlp_cases(self, rng, bits):
        """The tensor-core MLP body's edges (every container width; the
        32-bit one runs the CUDA-core body): K not a multiple of 32 (561, 8,
        33), N not a multiple of 8 (6, 10), widths at the routing
        predicate's limit (weights streamed through a chunk), 8 layers,
        batches around the 16-row tile up to 65536, fleets of 2 and 8 whose
        slices start off a 16-byte boundary (M 3089, K 561), a logistic
        fleet (one layer, N 6), full-range and edge values."""
        limit = self.K.tune.SMEM_PER_BLOCK // (2 * self.K.tune.MODEL_BLOCK_M
                                               * bits // 8)
        for dims in ((561, 64, 6), (8, 16, 10), (33, 40, 6), (64, 10),
                     (561, 6)):
            for m, regime in ((3089, "mid"), (31, "full"), (33, "edge")):
                self.mlp_shape_case(rng, bits, dims, m, regime=regime)
        for m in (1, 7, 15, 16, 17, 31, 3089, 65536):
            self.mlp_shape_case(rng, bits, (561, 64, 6), m,
                                regime="full" if m < 3089 else "mid")
        for dims in ((limit, 64, 6), (48, limit, 6), (limit, 6)):
            self.mlp_shape_case(rng, bits, dims, 40, regime="mid")
            self.mlp_shape_case(rng, bits, dims, 17, regime="edge")
        deep = (40, 32, 24, 48, 16, 33, 8, 12, 6)  # 8 layers
        self.mlp_shape_case(rng, bits, deep, 3089, regime="mid")
        self.mlp_shape_case(rng, bits, deep, 31, regime="edge")
        for e in (2, 8):
            for hetero in (False, True):
                self.mlp_shape_case(rng, bits, (561, 64, 6), 3089, e, hetero,
                                    "full" if hetero else "mid")
            self.mlp_shape_case(rng, bits, (561, 6), 3089, e, True, "mid")
            self.mlp_shape_case(rng, bits, (561, 6), 33, e, True, "edge")
        self.mlp_shape_case(rng, bits, deep, 100, 2, True, "mid")
        self.mlp_shape_case(rng, bits, (limit, 64, 6), 20, 2, True, "mid")

    def _svm_params(self, rng, bits, regime):
        """(fmt, out_fmt, q(gamma), q(coef0), degree, dec_shift): random,
        nonzero q(gamma)."""
        frac = bits - 6 if regime == "mid" else bits - 1 - rng.randint(0, 4)
        fmt = self.K.fxp.FxpFormat(bits, frac)
        out_fmt = self.K.fxp.FxpFormat(bits, rng.randint(0, bits))
        if regime == "mid":  # kernel values inside the format, not saturated
            qgamma = int(rng.randint(1, 2 ** max(1, frac // 2)))
            qcoef0 = int(rng.randint(-(2 ** frac), 2 ** frac))
        else:
            qgamma = int(rng.randint(1, 2 ** (bits - 1)))
            qcoef0 = int(rng.randint(-(2 ** (bits - 1)), 2 ** (bits - 1)))
        degree, dec_shift = 1 + rng.randint(0, 3), rng.randint(0, min(bits, 31))
        return fmt, out_fmt, qgamma, qcoef0, degree, dec_shift

    def svm_fleet_case(self, rng, bits, e, m, f, s, c, kind, regime,
                       slots=False):
        """E stacked SVMs, each its own formats, q(gamma), q(coef0) and
        degree, against the plain version; with ``slots``, each slot also
        against ``fxp_svm_model_cuda`` of that model alone."""
        K = self.K
        params = []
        for _ in range(e):  # each model its own formats and constants
            p = self._svm_params(rng, bits, regime)
            params.append((K.fxp.FxpFormat(bits, p[0].frac_bits),) + p[1:])
        params = tuple(params)
        x, sv, dual, icept = self._cuda(
            _ints(rng, (e, m, f), bits, regime),
            _ints(rng, (e, s, f), bits, regime),
            _ints(rng, (e, s, c), bits, "mid"),
            _ints(rng, (e, c), bits, "full"))
        got = K.model.fxp_svm_fleet_cuda(x, sv, dual, icept, kind, params)
        want = K.model.fxp_svm_fleet_plain(x, sv, dual, icept, kind, params)
        what = (f"w{bits} {kind} E={e} {m}x{f} S={s} C={c} q(gamma) "
                f"{[p[2] for p in params]} degrees {[p[4] for p in params]} "
                f"{regime}")
        self._compare("fxp_svm_fleet", got, want, what)
        if slots:
            for i, p in enumerate(params):
                solo = K.model.fxp_svm_model_cuda(x[i], sv[i], dual[i],
                                                  icept[i], kind, *p)
                self._compare("fxp_svm_fleet", got[i], solo,
                              f"{what}: slot {i} against fxp_svm_model")

    def svm_fleet_cases(self, rng, bits):
        """The fleet on the cluster body: E in SVM_FLEET_SIZES x S in
        SVM_LENGTHS x batches SVM_FLEET_BATCHES (D6 width where the plain
        version is cheap, D5 width elsewhere), poly and rbf in turn; and
        each slot of an E = 4 launch at path D's shape against the single
        model's kernel."""
        j = 0
        for e in SVM_FLEET_SIZES:
            for s in SVM_LENGTHS:
                for m in SVM_FLEET_BATCHES:
                    f = 561 if s <= N_PROTOTYPES and m <= 31 else 8
                    c = 6 if f == 561 else 10
                    self.svm_fleet_case(rng, bits, e, m, f, s, c,
                                        ("poly", "rbf")[j % 2],
                                        "full" if m == 31 else "mid")
                    j += 1
        for kind in ("poly", "rbf"):
            self.svm_fleet_case(rng, bits, 4, 3298, 8, N_PROTOTYPES, 10, kind,
                                "mid", slots=True)

    def layer_case(self, rng, bits, m, k, n, act, shift, frac, regime,
                   offset=0):
        """``offset`` rows dropped from the front of A: a row slice whose
        start is not 16-byte aligned.  Counts the cases whose int32 dot
        wrapped (first 64 rows, float64: exact at 8 and 16 bits) and the
        route each shape takes."""
        K, torch = self.K, self.torch
        fmt = K.fxp.FxpFormat(bits, frac)
        a, b, bias = self._cuda(
            _ints(rng, (m + offset, k), bits, regime),
            _ints(rng, (k, n), bits, regime),
            _ints(rng, (n,), bits, "full" if regime == "mid" else regime))
        a = a[offset:]
        got = K.layer.fxp_layer_cuda(a, b, bias, fmt, act, shift)
        want = K.layer.fxp_layer_plain(a, b, bias, fmt, act, shift)
        dot = a[:64].to(torch.float64) @ b.to(torch.float64)
        self.layer_wrapped += int(dot.abs().max() >= 2 ** 31)
        route = "narrow" if K.layer.narrow_plan(k, n) else "tile"
        self.layer_routes[route] += 1
        self._compare("fxp_layer", got, want,
                      f"w{bits} {m}x{k}x{n} {act} shift {shift} {regime} "
                      f"offset {offset} ({route})")

    def layer_narrow_cases(self, rng, bits):
        """fxp_layer around its narrow route: N in LAYER_NS x K in LAYER_KS
        at every activation (batches, regimes and shifts 0 / width - 1 in
        turn), row slices of A, and the largest K whose weights fit the
        narrow route beside the first K past it, at N 6 and 32."""
        acts = self.K.layer.LAYER_ACTIVATIONS
        regimes = ("mid", "full", "edge")
        i = 0
        for n in LAYER_NS:
            for k in LAYER_KS:
                for act in acts:
                    m = LAYER_BATCHES[i % len(LAYER_BATCHES)]
                    regime = regimes[i % len(regimes)]
                    shift = {"mid": _mid_shift(bits, k), "full": bits - 1,
                             "edge": 0}[regime]
                    frac = bits - 6 if regime == "mid" else bits - 1 - i % 2
                    self.layer_case(rng, bits, m, k, n, act, shift, frac,
                                    regime)
                    i += 1
        for k, n in ((561, 6), (300, 10), (8, 1), (561, 31)):
            for m, regime in ((3089, "mid"), (7, "full")):
                shift = _mid_shift(bits, k) if regime == "mid" else bits - 1
                frac = bits - 6 if regime == "mid" else bits - 1
                self.layer_case(rng, bits, m, k, n, acts[(k + m) % len(acts)],
                                shift, frac, regime, offset=1)
        for n in (6, 32):
            k_fit = max(k for k in range(1, 8192)
                        if self.K.layer.narrow_plan(k, n))
            for k in (k_fit, k_fit + 1):
                for m, regime in ((100, "mid"), (33, "full")):
                    shift = _mid_shift(bits, k) if regime == "mid" else 0
                    frac = bits - 6 if regime == "mid" else bits - 1
                    self.layer_case(rng, bits, m, k, n, "exact", shift, frac,
                                    regime)

    def model_case(self, rng, bits, m, dims, act, shifts, fracs, regime):
        K = self.K
        sched = tuple((s, K.fxp.FxpFormat(bits, f), a) for s, f, a in
                      zip(shifts, fracs, [act] * (len(dims) - 2) + ["none"]))
        x, = self._cuda(_ints(rng, (m, dims[0]), bits, regime))
        ws = self._cuda(*[_ints(rng, (i, o), bits, regime)
                          for i, o in zip(dims, dims[1:])])
        bs = self._cuda(*[_ints(rng, (o,), bits, "full") for o in dims[1:]])
        got = K.model.fxp_mlp_model_cuda(x, ws, bs, sched)
        want = K.model.fxp_mlp_model_plain(x, ws, bs, sched)
        self._compare("fxp_mlp_model", got, want,
                      f"w{bits} {m}x{dims} {act} shifts {shifts} {regime}")

    def qmatmul_case(self, rng, bits, m, k, n, regime, offset=0):
        """``offset`` rows dropped from the front of A (a row slice at any
        alignment).  Counts the cases whose int32 dot wrapped (first 64
        rows, float64)."""
        K, torch = self.K, self.torch
        frac = {"mid": bits - 6, "full": bits - 2, "edge": bits - 1}[regime]
        fmt = K.fxp.FxpFormat(bits, frac)
        a, b = self._cuda(_ints(rng, (m + offset, k), bits, regime),
                          _ints(rng, (k, n), bits, regime))
        a = a[offset:]
        got = K.qm.fxp_qmatmul_cuda(a, b, fmt)
        want = K.qm.fxp_qmatmul_plain(a, b, fmt)
        dot = a[:64].to(torch.float64) @ b.to(torch.float64)
        self.qmatmul_wrapped[bits] += int(dot.abs().max() >= 2 ** 31)
        self._compare("fxp_qmatmul", got, want,
                      f"w{bits} {m}x{k}x{n} m={frac} {regime} offset {offset}")

    def qmatmul_cases(self, rng, bits):
        """The tensor-core tile: M in BATCHES x K in QMATMUL_KS x N in
        QMATMUL_NS, the regimes in turn and all three at M 7, A a row slice
        every other case; a K past the point where one s32 partial of
        full-range 16-bit values would overflow (the accumulators wrap)."""
        regimes = ("mid", "full", "edge")
        i = 0
        for m in BATCHES:
            for k in QMATMUL_KS:
                for n in QMATMUL_NS:
                    for regime in (regimes if m == 7 else (regimes[i % 3],)):
                        self.qmatmul_case(rng, bits, m, k, n, regime,
                                          offset=i % 2)
                        i += 1
        self.qmatmul_case(rng, bits, 5, 40000, 9, "full")

    def tree_cases(self, tree, x_rows):
        """The tree on float rows with non-finite values and on every
        integer container (int32 rows in [2^24, 2^31) among them, where
        the cast rounds), with the node table in shared memory and, the
        budget lowered to 0 nodes, in device memory."""
        torch, fxp, te = self.torch, self.K.fxp, self.K.te
        rows = np.resize(x_rows, (max(BATCHES), x_rows.shape[1]))
        flt = torch.from_numpy(non_finite_rows(rows, tree)).cuda()
        finite = torch.from_numpy(rows).cuda()
        cases = [(tree, flt, "flt")]
        for fmt in (fxp.FxpFormat(8, 4), fxp.FXP16, fxp.FXP32,
                    fxp.FxpFormat(32, 28)):
            cases.append((tree.quantized(fmt), fxp.quantize(finite, fmt),
                          str(fmt)))
        rng = np.random.RandomState(7)
        big = (rng.randint(2 ** 24, 2 ** 31 - 1, rows.shape)
               * rng.choice([-1, 1], rows.shape)).astype(np.int32)
        cases.append((tree.quantized(fxp.FxpFormat(32, 28)),
                      torch.from_numpy(big).cuda(), "int32 in [2^24, 2^31)"))
        budget = te.TABLE_SMEM_NODES
        try:
            for route, limit in (("smem", budget), ("global", 0)):
                te.TABLE_SMEM_NODES = limit
                for t, x, what in cases:
                    if te.table_in_smem(t.n_nodes) != (route == "smem"):
                        raise AssertionError(f"tree table route: {route}")
                    for m in BATCHES:
                        self.tree_case(t, x[:m], f"{what} batch {m} {route}")
                        self.tree_routes[route] += 1
        finally:
            te.TABLE_SMEM_NODES = budget

    def svm_case(self, rng, bits, m, f, s, c, kind, regime):
        K, torch = self.K, self.torch
        x, sv, dual, icept = self._cuda(
            _ints(rng, (m, f), bits, regime), _ints(rng, (s, f), bits, regime),
            _ints(rng, (s, c), bits, "mid"), _ints(rng, (c,), bits, "full"))
        fmt, out_fmt, qgamma, qcoef0, degree, dec_shift = self._svm_params(
            rng, bits, regime)
        args = (x, sv, dual, icept, kind, fmt, out_fmt, qgamma, qcoef0, degree,
                dec_shift)
        got = K.model.fxp_svm_model_cuda(*args)
        want = K.model.fxp_svm_model_plain(*args)
        if m <= 64:
            dot = x[:1].to(torch.float64) @ sv.to(torch.float64).T
            self.wrapped += int(dot.abs().max() >= 2 ** 31)
        self._compare("fxp_svm_model", got, want,
                      f"w{bits} {kind} {m}x{f} S={s} C={c} degree {degree} "
                      f"q(gamma)={qgamma} q(coef0)={qcoef0} {regime}")

    def tree_case(self, tree, x, what):
        K = self.K
        got = K.te.tree_ensemble_cuda(tree, x)
        want = K.te.tree_ensemble_plain(tree, x)
        self._compare("tree_ensemble", got, want, what)

    def run(self, tree, x_rows):
        """Every case at the main paths' shapes, the new kernels' among
        them: the fleet kernels at E in {2, 8} and the PWL kernel on the
        (3089, 64) hidden layer."""
        rng = np.random.RandomState(0)
        acts = self.K.layer.LAYER_ACTIVATIONS
        shapes = ((561, 64), (64, 6), (561, 6))
        regimes = ("mid", "full", "edge")
        i = 0
        for bits in (8, 16, 32):
            # every activation x shape x regime at a ragged batch
            for act in acts:
                for k, n in shapes:
                    for regime in regimes:
                        shift = {"mid": _mid_shift(bits, k), "full": bits - 1,
                                 "edge": 0}[regime]
                        frac = bits - 6 if regime == "mid" else bits - 1 - i % 2
                        self.layer_case(rng, bits, 7, k, n, act, shift, frac,
                                        regime)
                        i += 1
            # every batch size at every shape
            for m in BATCHES:
                for k, n in shapes:
                    act = acts[i % len(acts)]
                    self.layer_case(rng, bits, m, k, n, act,
                                    _mid_shift(bits, k), bits - 6, "mid")
                    i += 1
            # the megakernel: every hidden activation x batch, and the edges
            for act in acts:
                for m in BATCHES:
                    shifts = (_mid_shift(bits, 561), _mid_shift(bits, 64))
                    self.model_case(rng, bits, m, (561, 64, 6), act, shifts,
                                    (bits - 6, bits - 6), "mid")
                for regime, shifts in (("full", (bits - 1, 0)),
                                       ("edge", (0, bits - 1))):
                    self.model_case(rng, bits, 64, (561, 64, 6), act, shifts,
                                    (bits - 1, 0), regime)
            # the SVM per-layer route's first stage on the tensor-core tile
            self.qmatmul_cases(rng, bits)
            # the SVM megakernel at the D6 and D5 shapes
            for f, c in ((561, 6), (8, 10)):
                for kind in ("poly", "rbf"):
                    for regime in regimes:
                        self.svm_case(rng, bits, 7, f, N_PROTOTYPES, c, kind,
                                      regime)
                    for m in BATCHES:
                        self.svm_case(rng, bits, m, f, N_PROTOTYPES, c, kind,
                                      "mid")
            # the megakernel's cluster split of the support vectors: one
            # vector to the fit predicate's limit, S not a multiple of
            # G x 64, ragged batches (D6 width where the plain version is
            # cheap, D5 width elsewhere)
            for kind in ("poly", "rbf"):
                for s in SVM_LENGTHS:
                    for m in SVM_BATCHES:
                        f = 561 if s <= N_PROTOTYPES and m <= 3089 else 8
                        self.svm_case(rng, bits, m, f, s, 6, kind,
                                      "full" if m == 31 else "mid")
            # the MLP megakernels' edges (tensor cores at 8 and 16 bits)
            self.mlp_cases(rng, bits)
            # fxp_layer's narrow route and its edges; the SVM fleet on the
            # cluster body
            self.layer_narrow_cases(rng, bits)
            # fxp_layer's wide route (the tile shared with fxp_qmatmul) on
            # a row slice of A that is not 16-byte aligned
            for j, m in enumerate((7, 3089, 65536)):
                regime = ("mid", "full", "edge")[j]
                shift = {"mid": _mid_shift(bits, 561), "full": bits - 1,
                         "edge": 0}[regime]
                self.layer_case(rng, bits, m, 561, 64, acts[j + 1], shift,
                                bits - 6 if regime == "mid" else bits - 1,
                                regime, offset=1 + j)
            self.svm_fleet_cases(rng, bits)
            # the fleet kernels: E in {2, 8}, uniform and per-model
            # schedules, ragged and full batches, int32-wrapping sums
            for e in (2, 8):
                for hetero in (False, True):
                    for m in (7, 3089):
                        self.mlp_fleet_case(rng, bits, e, m, hetero, "mid")
            self.mlp_fleet_case(rng, bits, 2, 64, True, "edge")
            for kind in ("poly", "rbf"):
                self.svm_fleet_case(rng, bits, 2, 7, 561, N_PROTOTYPES, 6,
                                    kind, "mid")
                self.svm_fleet_case(rng, bits, 4, 3298, 8, N_PROTOTYPES, 10,
                                    kind, "mid")
                self.svm_fleet_case(rng, bits, 2, 33, 8, N_PROTOTYPES, 10,
                                    kind, "edge")
        if not self.wrapped:
            raise AssertionError("no SVM case wrapped the int32 dot")
        if not self.mlp_wrapped:
            raise AssertionError("no MLP case wrapped the int32 dot")
        if not self.layer_wrapped:
            raise AssertionError("no fxp_layer case wrapped the int32 dot")
        if not (self.qmatmul_wrapped[16] and self.qmatmul_wrapped[32]):
            raise AssertionError(f"fxp_qmatmul cases that wrapped the int32 "
                                 f"dot, by width: {self.qmatmul_wrapped}")
        self.pwl_cases(rng)
        # the tree on float rows with non-finite values and on containers
        self.tree_cases(tree, x_rows)
        # flash_attention: float32 and bf16, causal and full, every head
        # dim, ragged and tile-aligned S, one head and the LM's 56
        torch = self.torch
        self.K.common.require_full_float32(torch.device("cuda", 0))
        gen = torch.Generator(device="cuda").manual_seed(0)
        for dtype in (torch.float32, torch.bfloat16):
            for causal in (True, False):
                for dh in self.K.fa.HEAD_DIMS:
                    for s in FLASH_LENGTHS:
                        for bh, group in FLASH_HEADS:
                            self.flash_case(gen, dtype, causal, dh, s, bh,
                                            group)
        # head dims between the instances (zero-padded), and float16 (the
        # float32 instance, rounded once), at the grouped LM shape
        for dtype in (torch.float32, torch.bfloat16, torch.float16):
            dims = FLASH_PADDED_DIMS + ((64,) if dtype == torch.float16
                                        else ())
            for dh in dims:
                for s in (7, 65, 2048):
                    for causal in (True, False):
                        self.flash_case(gen, dtype, causal, dh, s, 56, 7)
        self.flash_controls(gen)
        log(f"phase 3: {self.cases} kernel-vs-plain cases, bit-exact but "
            f"flash_attention (within 2e-5 in float32, {FLASH_BF16_ATOL} in "
            f"bf16: max abs err {self.flash_err}; bf16 rows within "
            f"{FLASH_BF16_ROW_RTOL} of their largest value: max "
            f"{self.flash_row_rel:.4e}) (max abs err {self.max_abs_err}; "
            f"{self.wrapped} SVM cases, {self.mlp_wrapped} MLP cases and "
            f"{self.layer_wrapped} fxp_layer cases wrapped the int32 dot; "
            f"fxp_layer routes {self.layer_routes}; fxp_qmatmul cases that "
            f"wrapped the int32 dot by width {self.qmatmul_wrapped}; "
            f"tree_ensemble table routes {self.tree_routes}; "
            f"pwl_activation cases with the fused bias "
            f"{self.pwl_bias_cases})")


# --------------------------------------------------------------------------
# phase 4: the main paths
# --------------------------------------------------------------------------
def plain_labels(torch, K, art, model, x):
    """The artifact's frozen program run through the plain versions on the
    card: quantize with the artifact's input format, then the plain kernel
    (float trees: the plain tree kernel on the rows as they are)."""
    xt = torch.from_numpy(x).cuda()
    spec = art.extras.get("emit_spec")
    if spec is None:  # flt tree
        return K.te.tree_ensemble_plain(model.tree, xt).cpu().numpy()
    family = spec["family"]
    if family == "tree":
        tree = K.trees.TreeArrays(
            spec["feature"], spec["threshold"], spec["left"], spec["right"],
            spec["leaf_class"], spec["max_depth"], model.tree.n_classes,
            model.tree.n_features)
        qx = K.fxp.quantize(xt, spec["in_fmt"])
        return K.te.tree_ensemble_plain(tree, qx).cpu().numpy()
    if family == "svm":
        qx = K.fxp.quantize(xt, spec["fmt"])
        sv, dual, b = (torch.from_numpy(spec[k]).cuda()
                       for k in ("sv", "dual", "b"))
        out = K.model.fxp_svm_model_plain(
            qx, sv, dual, b, spec["kernel"], spec["fmt"], spec["out_fmt"],
            spec["qgamma"], spec["qcoef0"], spec["degree"], spec["dec_shift"])
    elif family == "mlp":
        qx = K.fxp.quantize(xt, spec["in_fmt"])
        sched = tuple(zip(spec["shifts"], spec["out_fmts"], spec["acts"]))
        out = K.model.fxp_mlp_model_plain(
            qx, [torch.from_numpy(w).cuda() for w in spec["ws"]],
            [torch.from_numpy(b).cuda() for b in spec["bs"]], sched)
    else:
        qx = K.fxp.quantize(xt, spec["in_fmt"])
        out = K.layer.fxp_layer_plain(qx, torch.from_numpy(spec["w"]).cuda(),
                                      torch.from_numpy(spec["b"]).cuda(),
                                      spec["out_fmt"], "none", spec["shift"])
    return K.common.argmax_first(out).cpu().numpy()


def check_artifact(torch, K, art, model, x_test, n_classes, one, what):
    """predict on the test split and the batch ladder with ``one`` launches
    each; labels well-formed, stable across batches, equal to the plain
    versions'.  Returns the labels."""
    before = launch_counts(K)
    labels = art.predict(x_test)
    expect_launches(K, before, one, f"{what} predict")
    if labels.shape != (len(x_test),) or labels.dtype != np.int32:
        raise AssertionError(f"{what}: labels {labels.dtype}{labels.shape}")
    if labels.min() < 0 or labels.max() >= n_classes:
        raise AssertionError(f"{what}: label out of range")
    for b in LADDER:
        before = launch_counts(K)
        lab = art.predict(x_test[:b])
        expect_launches(K, before, one, f"{what} batch {b}")
        if not np.array_equal(lab, labels[:b]):
            raise AssertionError(f"{what}: batch {b} labels differ from the "
                                 f"full batch")
    if art.target.is_quantized or art.kind == "tree":
        plain = plain_labels(torch, K, art, model, x_test)
        if not np.array_equal(labels, plain):
            raise AssertionError(f"{what}: {int((labels != plain).sum())} "
                                 f"labels differ from the plain versions")
    return labels


def compile_per_layer(K, model, target, cal):
    os.environ["REPRO_MEGAKERNEL_VMEM"] = "0"
    try:
        art = K.tc.compile(model, target, calibration=cal)
    finally:
        del os.environ["REPRO_MEGAKERNEL_VMEM"]
    if art.kernel_strategy != "per-layer":
        raise AssertionError(f"forced route {art.kernel_strategy}")
    return art


def _ref_diff(K, model, kw, cal, x, labels):
    ref = K.tc.compile(model, K.tc.Target(backend="ref", **kw),
                       calibration=cal)
    return int((ref.predict(x) != labels).sum())


def main_path_mlp(torch, K, ds):
    """Main path A: the fixed-point MLP and logistic models on D6."""
    x_test, x_cal = ds.x_test, ds.x_train[:N_CALIBRATION]
    mlp = K.models.init_mlp([561, 64, 6], seed=0)
    rng = np.random.RandomState(0)
    logistic = K.models.LogisticModel(
        coef=(rng.randn(561, 6) * np.sqrt(2.0 / (561 + 6))).astype(np.float32),
        intercept=np.zeros(6, np.float32))
    arts, mlp_labels = {}, {}
    reset_launches(K)
    t0 = time.perf_counter()
    for tag, kw in TAGS.items():
        cal = x_cal if kw["number_format"].startswith("auto") else None
        for kind, m in (("mlp", mlp), ("logistic", logistic)):
            art = K.tc.compile(m, K.tc.Target(backend="cuda", **kw),
                               calibration=cal)
            arts[(kind, tag)] = art
            if kind == "mlp" and art.kernel_strategy != "megakernel":
                raise AssertionError(f"D6 mlp {tag} routed "
                                     f"{art.kernel_strategy}, not megakernel")
            one = {"fxp_mlp_model": 1} if kind == "mlp" else {"fxp_layer": 1}
            labels = check_artifact(torch, K, art, m, x_test, ds.n_classes,
                                    one, f"{kind} {tag}")
            if kind == "mlp":
                mlp_labels[tag] = labels
            diff = _ref_diff(K, m, kw, cal, x_test, labels)
            log(f"  {kind:8s} {tag:10s} labels {np.bincount(labels, minlength=6)}"
                f" == plain; rows differing ref vs cuda (int64 vs int32 "
                f"accumulator, information): {diff}")
        # the forced per-layer route: same labels, two fxp_layer launches
        per = compile_per_layer(K, mlp, K.tc.Target(backend="cuda", **kw), cal)
        before = launch_counts(K)
        if not np.array_equal(per.predict(x_test), mlp_labels[tag]):
            raise AssertionError(f"mlp {tag}: per-layer labels differ")
        expect_launches(K, before, {"fxp_layer": 2}, f"mlp {tag} per-layer")
    # flt: full float32 matmuls (PyTorch's default; the float predicts
    # refuse TF32), labels against float64 numpy
    for kind, m in (("mlp", mlp), ("logistic", logistic)):
        art = K.tc.compile(m, K.tc.Target(number_format="flt", backend="cuda"))
        check_flt(art.predict(x_test), _float64_logits(m, x_test),
                  f"{kind:8s} flt       ")
    launches = launch_counts(K)
    log(f"phase 4A: MLP/logistic path in {time.perf_counter() - t0:.1f} s; "
        f"kernel launches {launches}")
    for name in ("fxp_layer", "fxp_mlp_model"):
        if launches[name] == 0:
            raise AssertionError(f"main path A never launched {name}")
    return arts, launches


def check_flt(labels, logits, what):
    top2 = np.sort(logits, axis=1)[:, -2:]
    decided = (top2[:, 1] - top2[:, 0]) >= 1e-4
    if not np.array_equal(labels[decided], logits.argmax(1)[decided]):
        raise AssertionError(f"flt {what}: labels differ from float64")
    log(f"  {what} labels match float64 on "
        f"{int(decided.sum())}/{len(labels)} rows with top-2 gap >= 1e-4")


def _float64_logits(m, x):
    h = np.asarray(x, np.float64)
    if not hasattr(m, "weights"):  # logistic, svm-linear
        return h @ m.coef + m.intercept
    for i, (w, b) in enumerate(zip(m.weights, m.biases)):
        h = h @ w + b
        if i < len(m.weights) - 1:
            h = 1.0 / (1.0 + np.exp(-h))
    return h


def kernel_features(kind, x, sv, gamma, coef0, degree):
    dot = x @ sv.T
    if kind == "poly":
        return (gamma * dot + coef0) ** degree
    d2 = (x * x).sum(1)[:, None] - 2 * dot + (sv * sv).sum(1)[None, :]
    return np.exp(-gamma * d2)


def build_svms(K, ds, kinds):
    """SVM models of ``kinds`` on ``ds``: least-squares readouts (float64,
    one-hot targets) on the first N_FIT_ROWS train rows, of the raw
    features (linear) or of the kernel features of N_PROTOTYPES
    class-stratified prototypes with gamma = 1/(F var(x)) (sklearn's
    'scale'), coef0 1.0, degree 2.  No SVM trainer is ported yet."""
    x64 = ds.x_train.astype(np.float64)
    xf, yf = x64[:N_FIT_ROWS], ds.y_train[:N_FIT_ROWS]
    onehot = np.eye(ds.n_classes)[yf]

    def lstsq(h):
        sol = np.linalg.lstsq(np.c_[h, np.ones(len(h))], onehot, rcond=None)[0]
        return sol[:-1], sol[-1]

    gamma = 1.0 / (x64.shape[1] * max(x64.var(), 1e-12))
    sv = K.pick_prototypes(x64, ds.y_train, ds.n_classes, N_PROTOTYPES,
                               seed=0)
    out = {}
    for kind in kinds:
        if kind == "linear":
            coef, icept = lstsq(xf)
            out[kind] = K.models.SVMModel(
                "linear", coef=coef.astype(np.float32),
                intercept=icept.astype(np.float32), dtype="float32")
        else:
            dual, icept = lstsq(kernel_features(kind, xf, sv, gamma, 1.0, 2))
            out[kind] = K.models.SVMModel(kind, support_vectors=sv,
                                          dual_coef=dual, intercept=icept,
                                          gamma=gamma, coef0=1.0, degree=2)
    return out


def main_path_tree_svm(torch, K, d6, d5, tree_model):
    """Main path B: the D6 tree and SVMs, and the D5 kernel SVMs."""
    s6, s5 = build_svms(K, d6, ("linear", "poly", "rbf")), \
        build_svms(K, d5, ("poly", "rbf"))
    entries = [("tree", "D6", tree_model, TREE_TAGS, d6),
               ("svm-linear", "D6", s6["linear"], TREE_TAGS, d6),
               ("svm-poly", "D6", s6["poly"], SVM_TAGS, d6),
               ("svm-rbf", "D6", s6["rbf"], SVM_TAGS, d6),
               ("svm-poly", "D5", s5["poly"], SVM_TAGS, d5),
               ("svm-rbf", "D5", s5["rbf"], SVM_TAGS, d5)]
    arts = {}
    reset_launches(K)
    t0 = time.perf_counter()
    for kind, dname, model, tags, ds in entries:
        x_test, x_cal = ds.x_test, ds.x_train[:N_CALIBRATION]
        for tag in tags:
            kw = TAGS.get(tag, dict(number_format=tag))
            cal = x_cal if kw["number_format"].startswith("auto") else None
            art = K.tc.compile(model, K.tc.Target(backend="cuda", **kw),
                               calibration=cal)
            arts[(kind, dname, tag)] = art
            what = f"{dname} {kind} {tag}"
            if kind == "tree":
                one = {"tree_ensemble": 1}
            elif kind == "svm-linear":
                one = {"fxp_layer": 1} if tag != "flt" else {}
            else:
                one = {"fxp_svm_model": 1}
                if art.kernel_strategy != "megakernel":
                    raise AssertionError(f"{what} routed "
                                         f"{art.kernel_strategy}")
            labels = check_artifact(torch, K, art, model, x_test,
                                    ds.n_classes, one, what)
            if kind == "svm-linear" and tag == "flt":
                check_flt(labels, _float64_logits(model, x_test), what)
            diff = _ref_diff(K, model, kw, cal, x_test, labels)
            extra = ""
            if kind in ("svm-poly", "svm-rbf"):
                spec = art.extras["emit_spec"]
                extra = (f" q(gamma)={spec['qgamma']} "
                         f"q(coef0)={spec['qcoef0']} in {spec['fmt']}")
                per = compile_per_layer(
                    K, model, K.tc.Target(backend="cuda", **kw), cal)
                before = launch_counts(K)
                if not np.array_equal(per.predict(x_test), labels):
                    raise AssertionError(f"{what}: per-layer labels differ")
                expect_launches(K, before, {"fxp_qmatmul": 1, "fxp_layer": 1},
                                f"{what} per-layer")
            hist = np.bincount(labels, minlength=ds.n_classes)
            constant = " (constant)" if (hist > 0).sum() == 1 else ""
            log(f"  {dname} {kind:10s} {tag:10s} labels {hist}{constant} == "
                f"plain;{extra} rows differing ref vs cuda (information): "
                f"{diff}")
    launches = launch_counts(K)
    log(f"phase 4B: tree/SVM path in {time.perf_counter() - t0:.1f} s; "
        f"kernel launches {launches}")
    for name in ("fxp_layer", "fxp_qmatmul", "fxp_svm_model", "tree_ensemble"):
        if launches[name] == 0:
            raise AssertionError(f"main path B never launched {name}")
    return arts, launches


def emit_c_phase(K, arts_a, arts_b, d6, d5):
    """Phase 4F: C emission.  Every quantized artifact of paths A and B
    emits its freestanding fixed-point C (the paper's deliverable), built
    by the host's C compiler (``-std=c99 -ffreestanding -Werror``, and a
    hosted replay binary), the builds in parallel; the binary replays the
    test rows (quantized on the host) and must give the artifact's ``cuda``
    labels on every row.  Prints the measured sections beside the
    artifact's flash and SRAM model (the paper's Tables IV-VI).  Nothing of
    it runs on the card."""
    from concurrent.futures import ThreadPoolExecutor

    E = K.emit
    cc = E.find_cc()
    if cc is None:
        raise AssertionError("phase 4F: no C compiler (cc, gcc, clang) on "
                             "this host")
    jobs = [(f"D6 {kind} {tag}", art, d6)
            for (kind, tag), art in arts_a.items()]
    jobs += [(f"{dname} {kind} {tag}", art, d6 if dname == "D6" else d5)
             for (kind, dname, tag), art in arts_b.items()
             if art.target.is_quantized]

    def build_and_replay(job):
        what, art, ds = job
        t0 = time.perf_counter()
        src = art.emit_c()
        with E.CRunner(src, E.input_format(E.spec_of(art)), cc=cc) as run:
            labels, _ = run.predict(ds.x_test)
            return labels, run.sizes(), len(src), time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as pool:
        results = list(pool.map(build_and_replay, jobs))
    t_build = time.perf_counter() - t0
    log(f"phase 4F: C emission of {len(jobs)} quantized artifacts of paths "
        f"A and B with {cc}: emitted, built and replayed in {t_build:.1f} s")
    log(f"  {'artifact':26s} {'C chars':>8s} {'text':>7s} {'rodata':>8s} "
        f"{'data':>5s} {'bss':>6s} {'flash':>8s} {'model flash':>11s} "
        f"{'model sram':>10s}")
    for (what, art, ds), (labels, sec, n_chars, _) in zip(jobs, results):
        want = art.predict(ds.x_test)
        if not np.array_equal(labels, want):
            raise AssertionError(f"phase 4F {what}: the compiled C gives "
                                 f"{int((labels != want).sum())} labels "
                                 f"other than the cuda artifact's")
        mem = art.memory_report()
        log(f"  {what:26s} {n_chars:8d} {sec['text']:7d} {sec['rodata']:8d} "
            f"{sec['data']:5d} {sec['bss']:6d} {sec['flash']:8d} "
            f"{mem['flash']:11d} {mem['sram']:10d}")
    log(f"  every C label equals the cuda artifact's on all "
        f"{sum(len(ds.x_test) for _, _, ds in jobs)} test rows")


def _np_pwl(variant, h):
    """The float PWL sigmoids in float64 numpy (the flt yardstick)."""
    if variant == "pwl2":
        return np.clip(0.25 * h + 0.5, 0.0, 1.0)
    if variant == "rational":
        return 0.5 + 0.5 * h / (1.0 + np.abs(h))
    ax = np.abs(h)
    y = np.where(ax >= 5.0, 1.0, np.where(
        ax >= 2.375, 0.03125 * ax + 0.84375,
        np.where(ax >= 1.0, 0.125 * ax + 0.625, 0.25 * ax + 0.5)))
    return np.where(h >= 0, y, 1.0 - y)


def main_path_flt_pwl(torch, K, ds):
    """Main path C: the flt D6 MLP with a pwl2/pwl4/rational sigmoid on
    cuda, one pwl_activation launch per predict, against the plain route
    (the same model on the ``ref`` backend: float sigmoids in PyTorch ops)."""
    mlp = K.models.init_mlp([561, 64, 6], seed=0)
    x_test = ds.x_test
    reset_launches(K)
    t0 = time.perf_counter()
    for sig in ("pwl2", "pwl4", "rational"):
        art = K.tc.compile(mlp, K.tc.Target(sigmoid=sig, backend="cuda"))
        labels = check_artifact(torch, K, art, mlp, x_test, ds.n_classes,
                                {"pwl_activation": 1}, f"mlp flt {sig}")
        plain = K.tc.compile(mlp, K.tc.Target(sigmoid=sig, backend="ref"))
        before = launch_counts(K)
        plain_labels = plain.predict(x_test)
        expect_launches(K, before, {}, f"mlp flt {sig} plain route")
        h = np.asarray(x_test, np.float64)
        for i, (w, b) in enumerate(zip(mlp.weights, mlp.biases)):
            h = h @ w + b
            if i < len(mlp.weights) - 1:
                h = _np_pwl(sig, h)
        top2 = np.sort(h, axis=1)[:, -2:]
        decided = (top2[:, 1] - top2[:, 0]) >= 1e-4
        if not np.array_equal(labels[decided], plain_labels[decided]):
            raise AssertionError(f"mlp flt {sig}: labels differ from the "
                                 f"plain route on decided rows")
        log(f"  mlp      flt {sig:8s} labels "
            f"{np.bincount(labels, minlength=ds.n_classes)}: equal to the "
            f"plain route on all {len(labels)} rows "
            f"{np.array_equal(labels, plain_labels)} (required on the "
            f"{int(decided.sum())} rows with float64 top-2 gap >= 1e-4); "
            f"equal to float64 on "
            f"{int((labels == h.argmax(1))[decided].sum())} of them")
    launches = launch_counts(K)
    log(f"phase 4C: flt PWL path in {time.perf_counter() - t0:.1f} s; "
        f"kernel launches {launches}")
    if launches["pwl_activation"] == 0:
        raise AssertionError("main path C never launched pwl_activation")
    return launches


def serving_models(K, d6, d5):
    """The endpoints of main path D: 8 D6 MLPs (auto16, each calibrated on
    its own 2000-row slice of the train rows, so the schedules differ), 2
    D6 logistic models (fxp16), 4 D5 rbf SVMs (fxp32, prototypes and duals
    of their own), and the D6 tree is added by the caller."""
    out = {}
    for s in range(8):
        cal = d6.x_train[650 * s:650 * s + N_FIT_ROWS]
        out[f"mlp{s}"] = (K.models.init_mlp([561, 64, 6], seed=s),
                          dict(number_format="auto16"), cal, d6)
    for s in range(2):
        rng = np.random.RandomState(20 + s)
        model = K.models.LogisticModel(
            coef=(rng.randn(561, 6) * np.sqrt(2.0 / 567)).astype(np.float32),
            intercept=np.zeros(6, np.float32))
        out[f"logistic{s}"] = (model, dict(number_format="fxp16"), None, d6)
    x64 = d5.x_train.astype(np.float64)
    gamma = 1.0 / (x64.shape[1] * max(x64.var(), 1e-12))
    for s in range(4):
        sv = K.pick_prototypes(x64, d5.y_train, d5.n_classes, N_PROTOTYPES,
                               seed=s)
        rows = slice(1000 * s, 1000 * s + N_FIT_ROWS)
        onehot = np.eye(d5.n_classes)[d5.y_train[rows]]
        feats = kernel_features("rbf", x64[rows], sv, gamma, 1.0, 2)
        sol = np.linalg.lstsq(np.c_[feats, np.ones(len(feats))], onehot,
                              rcond=None)[0]
        out[f"rbf{s}"] = (K.models.SVMModel(
            "rbf", support_vectors=sv, dual_coef=sol[:-1], intercept=sol[-1],
            gamma=gamma, coef0=1.0, degree=2), dict(number_format="fxp32"),
            None, d5)
    return out


def main_path_serving(torch, K, d6, d5, tree_model):
    """Main path D: one InferenceService on the card serving 8 D6 MLPs, 2
    D6 logistic models, 4 D5 rbf SVMs and the D6 tree; enable_fleet forms
    three fleets, client threads submit 1-64-row requests, and every
    response must equal its member's own predict."""
    S = K.serve
    models = serving_models(K, d6, d5)
    models["tree"] = (tree_model, dict(number_format="fxp16"), None, d6)
    policy = S.BatchingPolicy(max_batch=64, max_wait_ms=2.0)
    t0 = time.perf_counter()
    svc = S.InferenceService()
    try:
        for name, (model, kw, cal, _) in models.items():
            svc.register(name, model, K.tc.Target(backend="cuda", **kw),
                         calibration=cal, policy=policy)
        plans = {tuple(svc.endpoint(f"mlp{s}").artifact.extras["emit_spec"]
                       ["shifts"]) for s in range(8)}
        arts = {n: svc.endpoint(n).artifact for n in models}
        golden = {n: arts[n].predict(ds.x_test)
                  for n, (_, _, _, ds) in models.items()}
        t_setup = time.perf_counter() - t0
        # each member's own predict, held against its frozen program run
        # through the plain versions on the card (as paths A and B do)
        for n, (model, _, _, ds) in models.items():
            plain = plain_labels(torch, K, arts[n], model, ds.x_test)
            if not np.array_equal(golden[n], plain):
                raise AssertionError(
                    f"{n}: {int((golden[n] != plain).sum())} labels of its "
                    f"own predict differ from the plain versions")
        reset_launches(K)
        t0 = time.perf_counter()
        formed = svc.enable_fleet()
        fleets = sorted(sorted(m) for m in formed.values())
        want = [[f"logistic{s}" for s in range(2)],
                [f"mlp{s}" for s in range(8)], [f"rbf{s}" for s in range(4)]]
        if fleets != want:
            raise AssertionError(f"enable_fleet formed {fleets}")
        errors, counts = [], []

        def client(seed):
            rng = np.random.RandomState(seed)
            names, futs = sorted(models), []
            for _ in range(60):
                n = names[rng.randint(len(names))]
                ds = models[n][3]
                k = int(rng.randint(1, 65))
                lo = int(rng.randint(0, len(ds.x_test) - k))
                futs.append((n, lo, k, svc.submit(n, ds.x_test[lo:lo + k])))
            for n, lo, k, f in futs:
                got = f.result(timeout=300)
                if not np.array_equal(got, golden[n][lo:lo + k]):
                    errors.append((n, lo, k))
            counts.append(len(futs))

        threads = [threading.Thread(target=client, args=(s,))
                   for s in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        if any(t.is_alive() for t in threads):
            raise AssertionError("a serving client did not finish")
        if errors or sum(counts) != 360:
            raise AssertionError(f"{len(errors)} responses differ from their "
                                 f"member's own predict: {errors[:5]}")
        stats = svc.stats()
    finally:
        svc.close()
    launches = launch_counts(K)
    for fleet in stats["_fleets"]:
        if fleet["stacked_dispatches"] < 1 or fleet["stack_fallbacks"] != 0:
            raise AssertionError(f"fleet {fleet}")
    tree = stats["tree"]
    if tree["batches"] < 1 or tree["coalesced_batches"] != 0:
        raise AssertionError(f"tree not served solo: {tree}")
    for name in ("fxp_mlp_fleet", "fxp_svm_fleet", "tree_ensemble"):
        if launches[name] == 0:
            raise AssertionError(f"main path D never launched {name}")
    log(f"phase 4D: serving path: {len(models)} endpoints registered in "
        f"{t_setup:.1f} s ({len(plans)} distinct MLP schedules), each "
        f"member's own predict equal to the plain versions; 360 requests "
        f"of 1-64 rows from 6 threads in {time.perf_counter() - t0:.1f} s, "
        f"every response equal to its member's own predict; kernel "
        f"launches {launches}")
    for fleet in stats["_fleets"]:
        log(f"  fleet {fleet['members']}: rounds {fleet['rounds']}, stacked "
            f"{fleet['stacked_dispatches']}, solo batches "
            f"{fleet['solo_batches']}, fallbacks {fleet['stack_fallbacks']}, "
            f"staging allocs {fleet['staging_allocs']}")
    log(f"  tree served solo: {tree['batches']} batches, "
        f"{tree['requests']} requests")
    return launches, arts


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _rel_err(a, b):
    """max |a - b| / max |b|, one batch row at a time (the full-width logits
    are 5 GB: no third copy)."""
    err = scale = 0.0
    for i in range(a.shape[0]):
        err = max(err, float((a[i] - b[i]).abs().max()))
        scale = max(scale, float(b[i].abs().max()))
    return err / scale


def _lm_tokens(torch, cfg, shape, seed):
    return torch.from_numpy(np.random.RandomState(seed).randint(
        1, cfg.vocab_size, shape).astype(np.int32)).cuda()


def _decode_logits(torch, M, cfg, params, tok, max_len):
    """serve_step along ``tok`` (B, T) from a fresh cache: (B, T, vocab)."""
    cache = M.init_cache(cfg, tok.shape[0], max_len, tok.device)
    out = []
    for i in range(tok.shape[1]):
        logits, cache = M.serve_step(params, cache, {"token": tok[:, i]}, cfg)
        out.append(logits)
    return torch.stack(out, 1)


@contextlib.contextmanager
def gate_route(K, kernel):
    """The route of the LM's SiLU gate: the port's own (True: on the card, a
    pwl4 gate is one silu_pwl4 launch of pwl_activation) or, patched in,
    the op-by-op PyTorch route that preceded it (False), the yardstick the
    kernel route is held to and timed beside."""
    layers = K.lm_layers
    route = layers.gated_silu
    if not kernel:
        layers.gated_silu = lambda x, gate="exact": \
            x * layers.get_sigmoid(gate)(x)
    try:
        yield
    finally:
        layers.gated_silu = route


def check_gate_route(torch, K, cfg, params, tok, fwd):
    """Path E's pwl4 gate through the kernel against the op-by-op route, at
    the served artifact's weights: in float32 the two forwards within 1e-4
    (relative to the largest logit); in bf16 the kernel route (``fwd``) no
    further from the float32 logits than 1.5x the op-by-op route."""
    M = K.lm_model
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    p32 = _tree_map(lambda t: t.to(torch.float32) if t.is_floating_point()
                    else t, params)
    with gate_route(K, False):
        eager = M.forward(params, {"tokens": tok}, cfg)
        eager32 = M.forward(p32, {"tokens": tok}, cfg32)
    with gate_route(K, True):
        fused32 = M.forward(p32, {"tokens": tok}, cfg32)
    rel32 = _rel_err(fused32, eager32)
    rel_k, rel_o = _rel_err(fwd, eager32), _rel_err(eager, eager32)
    if not rel32 <= 1e-4:
        raise AssertionError(f"pwl4 gate: float32 kernel route {rel32} from "
                             f"the op-by-op route, over 1e-4")
    if not rel_k <= 1.5 * rel_o:
        raise AssertionError(f"pwl4 gate: bf16 kernel route {rel_k} from the "
                             f"float32 logits, over 1.5 x the op-by-op "
                             f"route's {rel_o}")
    return (f"; pwl4 gate through the kernel: float32 within {rel32:.3e} of "
            f"the op-by-op gate (bound 1e-4), bf16 {rel_k:.3e} from the "
            f"float32 logits against the op-by-op gate's {rel_o:.3e} (bound "
            f"1.5x)")


def main_path_lm(torch, K):
    """Main path E: qwen2-0.5b at its published widths, seeded weights.

    1. bf16 prefill: ``forward`` at batch 4 x 2048 tokens, exactly one
       flash_attention launch per layer.  With the same weights in float32,
       the kernel route's logits are within 1e-4 (max |dlogit| / max
       |logit|) of the same forward with its attention through the
       materialized-scores oracle; in bf16 the kernel route is no further
       than 1.5x the oracle route's distance from those float32 logits.
    2. float32: decode (serve_step over the KV cache) against forward,
       batch 2 x 12 steps, relative error < 2e-3.
    3. serving: one InferenceService registers the model at flt (bf16) and
       at fxp8/qnm with an int8 KV cache and the pwl4 gate; generate (batch
       4, 32 tokens) on each makes no flash_attention launch, every token is
       the argmax of serve_step's logits along the sequence, and those
       logits agree with the prefill's over the same tokens (a misplaced
       cache entry or position would put the two an order of the logits
       apart; the bound is 0.25 of the largest logit).
    """
    M, cfg = K.lm_model, K.configs.get_config(LM_ARCH)
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    n_params = sum(t.numel() for t in _leaves(params))
    torch.cuda.synchronize()
    log(f"phase 4E: {LM_ARCH} at full width ({cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads} heads / {cfg.n_kv_heads} KV, dh "
        f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, tied "
        f"embeddings): {n_params} seeded {cfg.dtype} parameters in "
        f"{time.perf_counter() - t0:.1f} s")
    reset_launches(K)
    zero = launch_counts(K)
    tok = _lm_tokens(torch, cfg, (LM_BATCH, LM_SEQ), 0)
    t0 = time.perf_counter()
    logits = M.forward(params, {"tokens": tok}, cfg)
    torch.cuda.synchronize()
    t_fwd = time.perf_counter() - t0
    expect_launches(K, zero, {"flash_attention": cfg.n_layers},
                    "bf16 prefill forward")
    if (logits.shape != (LM_BATCH, LM_SEQ, cfg.vocab_size)
            or logits.dtype != torch.float32
            or not bool(torch.isfinite(logits).all())):
        raise AssertionError(f"prefill logits {logits.dtype}"
                             f"{tuple(logits.shape)} not finite float32 of "
                             f"the expected shape")
    # The same weights in float32: the kernel route against the oracle's
    # attention, and the float32 logits that both bf16 routes are held to.
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    p32 = _tree_map(lambda t: t.to(torch.float32), params)
    before = launch_counts(K)
    ref32 = M.forward(p32, {"tokens": tok}, cfg32, attn_impl="ref")
    expect_launches(K, before, {}, "float32 prefill through the oracle")
    f32 = M.forward(p32, {"tokens": tok}, cfg32)
    expect_launches(K, before, {"flash_attention": cfg.n_layers},
                    "float32 prefill")
    rel32 = _rel_err(f32, ref32)
    del ref32
    if not rel32 <= 1e-4:
        raise AssertionError(f"float32 prefill: kernel route against the "
                             f"oracle's attention, rel err {rel32} > 1e-4")
    rel_k = _rel_err(logits, f32)
    before = launch_counts(K)
    plain = M.forward(params, {"tokens": tok}, cfg, attn_impl="ref")
    expect_launches(K, before, {}, "bf16 prefill through the oracle")
    rel_o = _rel_err(plain, f32)
    rel = _rel_err(logits, plain)
    del logits, plain, f32
    # bf16 rounds every layer's output: two bf16 forwards that sum in other
    # orders part by about as much as either parts from float32, so the
    # kernel route is held to the oracle route's distance from float32.
    if not rel_k <= 1.5 * rel_o:
        raise AssertionError(f"bf16 prefill: kernel route {rel_k} from the "
                             f"float32 logits, over 1.5 x the oracle "
                             f"route's {rel_o}")
    log(f"  bf16 prefill {LM_BATCH} x {LM_SEQ} tokens: {cfg.n_layers} "
        f"flash_attention launches, first call {t_fwd:.2f} s.  float32, "
        f"same weights: kernel route within {rel32:.3e} of the oracle's "
        f"attention (bound 1e-4).  bf16: kernel route {rel_k:.3e} and oracle "
        f"route {rel_o:.3e} from the float32 logits (bound 1.5x the "
        f"oracle's), {rel:.3e} from each other (relative to the largest "
        f"logit)")

    tok = _lm_tokens(torch, cfg, (LM_DECODE_BATCH, LM_DECODE_STEPS), 1)
    before = launch_counts(K)
    fwd = M.forward(p32, {"tokens": tok}, cfg32)
    expect_launches(K, before, {"flash_attention": cfg.n_layers},
                    "float32 forward")
    dec = _decode_logits(torch, M, cfg32, p32, tok, LM_DECODE_STEPS + 2)
    rel32 = _rel_err(dec, fwd)
    del p32, fwd, dec
    if not rel32 < 2e-3:
        raise AssertionError(f"float32 decode against forward: rel err "
                             f"{rel32} >= 2e-3")
    log(f"  float32 decode ({LM_DECODE_BATCH} x {LM_DECODE_STEPS} steps over "
        f"the KV cache) against the kernel's forward: rel err {rel32:.3e} "
        f"(bound 2e-3)")

    S = K.serve
    targets = {
        "flt": K.tc.Target(number_format="flt"),
        "fxp8_qnm_kv8_pwl4": K.tc.Target(number_format="fxp8",
                                         weight_scale="qnm", kv_cache="int8",
                                         sigmoid="pwl4"),
    }
    start = np.random.RandomState(2).randint(
        1, cfg.vocab_size, (LM_GEN_BATCH,)).astype(np.int32)
    serving = {}
    svc = S.InferenceService()
    try:
        for name, target in targets.items():
            t0 = time.perf_counter()
            art = svc.register(name, K.tc.LMModel(cfg, params), target).artifact
            t_reg = time.perf_counter() - t0
            svc.generate(name, start, 2)  # warm-up: allocations
            gated = art.extras["cfg"].gate_sigmoid == "pwl4"
            # the pwl4 gate: one silu_pwl4 launch per layer and step
            per_step = {"pwl_activation": cfg.n_layers} if gated else {}
            before = launch_counts(K)
            t0 = time.perf_counter()
            seqs = svc.generate(name, start, LM_GEN_TOKENS)
            ms_tok = (time.perf_counter() - t0) * 1e3 / LM_GEN_TOKENS
            expect_launches(K, before, {k: v * LM_GEN_TOKENS
                                        for k, v in per_step.items()},
                            f"generate at {name}")
            if (seqs.shape != (LM_GEN_BATCH, LM_GEN_TOKENS + 1)
                    or seqs.dtype != np.int32 or seqs.min() < 0
                    or seqs.max() >= cfg.vocab_size
                    or not np.array_equal(seqs[:, 0], start)):
                raise AssertionError(f"generate at {name}: {seqs.dtype}"
                                     f"{seqs.shape} [{seqs.min()}, "
                                     f"{seqs.max()}]")
            acfg, ap = art.extras["cfg"], art.extras["params"]
            seq_t = torch.from_numpy(seqs).cuda()
            dec = _decode_logits(torch, M, acfg, ap, seq_t[:, :-1],
                                 LM_GEN_TOKENS + 4)
            if not torch.equal(dec.argmax(-1).to(torch.int32), seq_t[:, 1:]):
                raise AssertionError(f"generate at {name}: tokens are not the "
                                     f"argmax of serve_step's logits")
            before = launch_counts(K)
            fwd = M.forward(ap, {"tokens": seq_t[:, :-1]}, acfg)
            expect_launches(K, before, {"flash_attention": cfg.n_layers,
                                        **per_step},
                            f"prefill of the {name} artifact")
            gate_note = check_gate_route(torch, K, acfg, ap, seq_t[:, :-1],
                                         fwd) if gated else ""
            rel_g = _rel_err(dec, fwd)
            agree = float((fwd.argmax(-1).to(torch.int32)
                           == seq_t[:, 1:]).float().mean())
            if not rel_g < 0.25:
                raise AssertionError(f"generate at {name}: serve_step logits "
                                     f"against prefill, rel err {rel_g}")
            serving[name] = dict(ms_per_token=ms_tok, artifact=art,
                                 flash_bytes=art.memory_report()["flash"],
                                 quantized_bytes=art.extras["quantized_bytes"],
                                 register_s=t_reg, rel=rel_g, agree=agree)
            log(f"  served {name}: registered in {t_reg:.1f} s, artifact "
                f"{serving[name]['flash_bytes']} bytes "
                f"({serving[name]['quantized_bytes']} quantized); generate "
                f"batch {LM_GEN_BATCH} x {LM_GEN_TOKENS} tokens: "
                f"{ms_tok:.2f} ms/token, no flash_attention launch; decode "
                f"logits within {rel_g:.3e} of the prefill's, which picks "
                f"the same token at {agree:.1%} of the steps; sample "
                f"{seqs[0, :8].tolist()}{gate_note}")
        stats = {n: svc.stats()[n] for n in targets}
    finally:
        svc.close()
    for n, st in stats.items():
        if st["batches"] != 2 or st["rows"] != LM_GEN_BATCH * (LM_GEN_TOKENS + 2):
            raise AssertionError(f"endpoint {n} stats {st}")
    launches = launch_counts(K)
    if launches["flash_attention"] == 0:
        raise AssertionError("main path E never launched flash_attention")
    log(f"  kernel launches on path E: {launches}")
    return launches, dict(cfg=cfg, params=params, serving=serving)


# --------------------------------------------------------------------------
# phase 4G: the paper's pipeline (train -> compile -> archive -> load -> HTTP)
# --------------------------------------------------------------------------
PIPELINE_TAGS = ("fxp16", "auto8")
PIPELINE_PROTOTYPES = 400
# a trained model's flt test accuracy must exceed chance (1 / classes) by
# this much
CHANCE_MARGIN = 0.5
HTTP_SIZES = (1, 16, 256)  # rows per request, in turns
HTTP_CLIENTS = 8
KIND_KERNEL = {"mlp": "fxp_mlp_model", "logistic": "fxp_layer",
               "svm-linear": "fxp_layer", "svm-poly": "fxp_svm_model",
               "svm-rbf": "fxp_svm_model", "tree": "tree_ensemble"}


def _flt_accuracy(K, model, ds):
    art = K.tc.compile(model, K.tc.Target(number_format="flt",
                                          backend="cuda"))
    return float((art.predict(ds.x_test) == ds.y_test).mean())


def _archive_members(K, path):
    with open(path, "rb") as f:
        payload = K.ckpt.unpackb(K.ckpt.decompress_bytes(f.read()))
    return {k: K.ckpt.unpackb(v) for k, v in payload["members"].items()}


def _http_requests(server, jobs, bodies, clients):
    """POST every (name, rows) job, with its JSON body from ``bodies``,
    from ``clients`` threads, each on its own keep-alive connection;
    returns (responses and request latencies in s, by job index, and the
    wall seconds)."""
    import http.client

    out, lat, errors = [None] * len(jobs), [0.0] * len(jobs), []

    def client(c):
        conn = http.client.HTTPConnection(server.host, server.port,
                                          timeout=120)
        try:
            for i in range(c, len(jobs), clients):
                t0 = time.perf_counter()
                conn.request("POST", f"/v1/predict/{jobs[i][0]}", body=bodies[i],
                             headers={"Content-Type": "application/json"})
                resp = conn.getresponse()
                payload = json.loads(resp.read())
                dt = time.perf_counter() - t0
                if resp.status != 200:
                    raise AssertionError(f"{jobs[i][0]}: HTTP "
                                         f"{resp.status} {payload}")
                out[i], lat[i] = payload["predictions"], dt
        except Exception as e:  # reported by the caller
            errors.append(e)
        finally:
            conn.close()

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(c,))
               for c in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    wall = time.perf_counter() - t0
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"HTTP clients failed: {errors[:3]}")
    return out, lat, wall


def _inproc_requests(svc, jobs, clients):
    """The same jobs through ``svc.predict`` from ``clients`` threads:
    (latencies in s by job index, wall seconds)."""
    lat, errors = [0.0] * len(jobs), []

    def client(c):
        try:
            for i in range(c, len(jobs), clients):
                name, rows = jobs[i]
                t0 = time.perf_counter()
                svc.predict(name, rows)
                lat[i] = time.perf_counter() - t0
        except Exception as e:  # reported by the caller
            errors.append(e)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(c,))
               for c in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"in-process clients failed: {errors[:3]}")
    return lat, time.perf_counter() - t0


def _http_get(server, path):
    import http.client

    conn = http.client.HTTPConnection(server.host, server.port, timeout=60)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def _latency_line(lat, wall, n):
    ms = np.asarray(lat) * 1e3
    return (f"{n / wall:.1f} requests/s, p50 {np.percentile(ms, 50):.3f} ms, "
            f"p99 {np.percentile(ms, 99):.3f} ms")


def main_path_pipeline(torch, K, ds, tree_model):
    """Main path G: the paper's pipeline on D6 at full width.  Train each
    classifier on the card (the tree is main()'s CART), compile it at fxp16
    and auto8 on ``cuda``, save each archive with its C, load each on the
    card (labels and C equal to the saved artifact's), serve the loaded
    archives over HTTP (every test row of every endpoint in requests of 1,
    16 and 256 rows, labels equal to the in-process labels), and refuse a
    corrupted archive."""
    import asyncio

    M, C = K.models, ds.n_classes
    x_tr, y_tr, x_cal = ds.x_train, ds.y_train, ds.x_train[:N_CALIBRATION]
    out_dir = os.path.join(ROOT, "build", "pipeline")
    os.makedirs(out_dir, exist_ok=True)
    reset_launches(K)
    t_phase = time.perf_counter()
    trainers = {
        "mlp": lambda: M.train_mlp(x_tr, y_tr, C, hidden=(64,)),
        "logistic": lambda: M.train_logistic(x_tr, y_tr, C),
        "svm-linear": lambda: M.train_linear_svm(x_tr, y_tr, C),
        "svm-rbf": lambda: M.train_kernel_svm(
            x_tr, y_tr, C, kernel="rbf", n_prototypes=PIPELINE_PROTOTYPES),
        "svm-poly": lambda: M.train_kernel_svm(
            x_tr, y_tr, C, kernel="poly", n_prototypes=PIPELINE_PROTOTYPES),
    }
    models, floor = {}, 1.0 / C + CHANCE_MARGIN
    for kind, train in trainers.items():
        t0 = time.perf_counter()
        models[kind] = train()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        acc = _flt_accuracy(K, models[kind], ds)
        log(f"  4G train {kind:10s} on the card in {secs:.2f} s; flt test "
            f"accuracy {acc:.4f}")
        if acc < floor:
            raise AssertionError(f"4G: trained {kind} accuracy {acc:.4f} "
                                 f"under chance + {CHANCE_MARGIN} ({floor:.4f})")
    models["tree"] = tree_model
    acc_tree = _flt_accuracy(K, tree_model, ds)
    acc_mlp = _flt_accuracy(K, models["mlp"], ds)
    acc_init = _flt_accuracy(K, M.init_mlp([561, 64, 6], seed=0), ds)
    log(f"  4G tree (main()'s CART) flt accuracy {acc_tree:.4f}; untrained "
        f"init_mlp (path A's MLP) {acc_init:.4f} against trained "
        f"{acc_mlp:.4f}")
    if acc_tree < floor or acc_mlp <= acc_init:
        raise AssertionError("4G: the tree is under chance + margin or the "
                             "trained MLP does not beat the untrained one")

    arts, paths = {}, {}
    t0 = time.perf_counter()
    for kind, model in models.items():
        for tag in PIPELINE_TAGS:
            kw = TAGS[tag]
            cal = x_cal if kw["number_format"].startswith("auto") else None
            art = K.tc.compile(model, K.tc.Target(backend="cuda", **kw),
                               calibration=cal)
            path = os.path.join(out_dir, f"{kind}-{tag}.embml")
            art.save(path, metadata={"dataset": "D6"}, include_c=True)
            arts[(kind, tag)], paths[(kind, tag)] = art, path
    log(f"  4G compiled and saved {len(arts)} archives (include_c) in "
        f"{time.perf_counter() - t0:.2f} s: "
        f"{sum(os.path.getsize(p) for p in paths.values())} bytes")

    loaded, labels = {}, {}
    for key, path in paths.items():
        t0 = time.perf_counter()
        again = K.tc.load(path)
        t_load = time.perf_counter() - t0
        before = launch_counts(K)
        got = again.predict(ds.x_test)
        expect_launches(K, before, {KIND_KERNEL[key[0]]: 1},
                        f"4G loaded {key} predict")
        want = arts[key].predict(ds.x_test)
        if again.device != arts[key].device or not np.array_equal(got, want):
            raise AssertionError(f"4G: loaded {key} gives other labels "
                                 f"than the saved artifact")
        meta = _archive_members(K, path)["metadata"]
        if meta.get("emit_c") != again.emit_c():
            raise AssertionError(f"4G: {key} archive's C is not emit_c()")
        loaded[key], labels[key] = again, got
        log(f"  4G load {key[0]:10s} {key[1]:6s} {t_load * 1e3:8.2f} ms "
            f"({os.path.getsize(path)} bytes); labels on {len(got)} rows "
            f"and the carried C equal the saved artifact's; test accuracy "
            f"{float((got == ds.y_test).mean()):.4f}")

    svc = K.serve.InferenceService()
    loop = asyncio.new_event_loop()
    loop_thread = threading.Thread(target=loop.run_forever, daemon=True)
    loop_thread.start()
    server = None
    try:
        names = {}
        for key, art in loaded.items():
            names[key] = f"{key[0]}-{key[1]}"
            svc.register(names[key], artifact=art,
                         policy=K.serve.BatchingPolicy(max_batch=256,
                                                       max_wait_ms=1.0))
        server = svc.serve_http("127.0.0.1", 0)
        asyncio.run_coroutine_threadsafe(server.start(), loop).result(60)
        jobs, spans = [], []
        for key in loaded:
            lo, i = 0, 0
            while lo < len(ds.x_test):
                k = HTTP_SIZES[i % len(HTTP_SIZES)]
                jobs.append((names[key], ds.x_test[lo:lo + k]))
                spans.append((key, lo, min(lo + k, len(ds.x_test))))
                lo, i = lo + k, i + 1
        for name in names.values():  # the first request of each endpoint
            svc.predict(name, ds.x_test[:1])
        # each row's JSON made once, before the clock: the clients then
        # only join strings, and the timing is the server's
        row_json = [json.dumps(r) for r in ds.x_test.tolist()]
        bodies = ['{"rows": [' + ",".join(row_json[lo:hi]) + "]}"
                  for _, lo, hi in spans]
        out, lat, wall = _http_requests(server, jobs, bodies, HTTP_CLIENTS)
        for (key, lo, hi), preds in zip(spans, out):
            if not np.array_equal(np.asarray(preds), labels[key][lo:hi]):
                raise AssertionError(f"4G: HTTP labels of {key} rows "
                                     f"{lo}:{hi} differ from in-process")
        status_h, health = _http_get(server, "/v1/health")
        status_s, stats = _http_get(server, "/v1/stats")
        if (status_h, health) != (200, {"status": "ok",
                                        "endpoints": len(names)}):
            raise AssertionError(f"4G /v1/health: {status_h} {health}")
        if status_s != 200 or set(stats["slo"]) != set(names.values()):
            raise AssertionError(f"4G /v1/stats: {status_s}")
        in_lat, in_wall = _inproc_requests(svc, jobs, HTTP_CLIENTS)
        log(f"  4G HTTP: {len(jobs)} requests ({len(names)} endpoints x "
            f"{len(ds.x_test)} rows in requests of {HTTP_SIZES} rows, "
            f"{HTTP_CLIENTS} clients): {_latency_line(lat, wall, len(jobs))}; "
            f"every label equal to the in-process label; /v1/health and "
            f"/v1/stats answer")
        log(f"  4G in process, the same requests: "
            f"{_latency_line(in_lat, in_wall, len(jobs))}")
        sizes = np.array([hi - lo for _, lo, hi in spans])
        for k in HTTP_SIZES:
            pick = sizes == k
            h = np.asarray(lat)[pick] * 1e3
            p = np.asarray(in_lat)[pick] * 1e3
            log(f"  4G requests of {k:3d} rows ({int(pick.sum())}): HTTP p50 "
                f"{np.percentile(h, 50):.3f} p99 {np.percentile(h, 99):.3f} "
                f"ms; in process p50 {np.percentile(p, 50):.3f} p99 "
                f"{np.percentile(p, 99):.3f} ms")
    finally:
        if server is not None:
            asyncio.run_coroutine_threadsafe(server.stop(), loop).result(60)
        loop.call_soon_threadsafe(loop.stop)
        loop_thread.join(60)
        loop.close()
        svc.close()

    src = paths[("mlp", "fxp16")]
    bad = os.path.join(out_dir, "corrupt.embml")
    raw = bytearray(open(src, "rb").read())
    raw[len(raw) // 2] ^= 0x01
    with open(bad, "wb") as f:
        f.write(bytes(raw))
    try:
        K.tc.load(bad)
    except K.tc.ArtifactIntegrityError as e:
        log(f"  4G a one-byte flip is refused: {str(e)[:96]}")
    else:
        raise AssertionError("4G: a corrupted archive loaded")
    launches = launch_counts(K)
    for name in set(KIND_KERNEL.values()):
        if launches[name] == 0:
            raise AssertionError(f"main path G never launched {name}")
    log(f"phase 4G: pipeline path in {time.perf_counter() - t_phase:.1f} s; "
        f"kernel launches {launches}")
    return launches


# --------------------------------------------------------------------------
# phase 5: timing
# --------------------------------------------------------------------------
def cuda_ms(torch, fn, iters):
    """(ms per call between CUDA events, host ms per call to issue it).
    When the two are close, the loop is bound by the host, not the card."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3 / iters
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters, host_ms


def device_ms(torch, fn, iters=20, attempts=3):
    """Device time per call of ``fn`` (ms): the sum of its kernels' device
    time in a torch.profiler trace of ``iters`` calls.  Below ~0.04 ms a
    CUDA-event loop measures the host's launch cost instead.  A trace that
    now and then holds no device event is taken again (0.0 after
    ``attempts`` empty traces)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    total = 0
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA)
        if total:
            break
    return total / 1e3 / iters


class Timer:
    """Phase 5: kernel times beside their bounds; keeps the record of each
    kernel at its recorded shape for the JSON line."""

    def __init__(self, torch, dev, check, launches):
        self.torch, self.dev, self.check = torch, dev, check
        self.launches = launches  # name -> (total, by path)
        self.records = {}
        log("phase 5: kernel times (CUDA events, warm L2, mean over iterations)")
        log(f"  {'kernel':14s} {'tag':10s} {'batch':>6s} {'ms':>9s} "
            f"{'host_ms':>9s} {'plain_ms':>9s} {'bound_ms':>9s} bound_by")

    def time(self, name, tag, m, kern, plain, nbytes, ops, peak, record,
             source, replaces, shape=None, profile=False):
        iters = 200 if m <= 3298 else 20
        ms, host_ms = cuda_ms(self.torch, kern, iters)
        plain_ms, _ = cuda_ms(self.torch, plain, max(3, iters // 20))
        bound_ms, bound_by = self.dev.bound(nbytes, ops, peak)
        dev_ms = device_ms(self.torch, kern) if record or profile else None
        log(f"  {name:14s} {tag:10s} {m:6d} {ms:9.4f} {host_ms:9.4f} "
            f"{plain_ms:9.4f} {bound_ms:9.5f} {bound_by}"
            + ("" if dev_ms is None else f"; profiler device {dev_ms:.4f}"))
        if record:
            total, by_path = self.launches[name]
            self.records[name] = {
                "name": name, "route": "cuda",
                "source": f"src/repro_torch/kernels/csrc/{source}",
                "replaces": replaces, "launches": total,
                "launches_by_path": by_path,
                "max_abs_err": self.check.max_abs_err[name],
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": None,
                "device_ms": dev_ms,
                "shape": shape or f"{tag} D6 test split, batch {m}"}
        return ms


def log_cuda_core_bound(dev, nbytes, ops, bits):
    """The MLP megakernels' bound on the CUDA cores (their route before the
    tensor cores), printed beside the tensor-core bound the record keeps."""
    ms, by = dev.bound(nbytes, ops, dev.int_peak(bits))
    log(f"  {'':14s} CUDA-core bound {ms:.5f} ms ({by})")


def time_mlp(torch, K, T, arts, x_big, n_test):
    for tag in ("fxp16", "auto8", "fxp32"):
        for kind in ("mlp", "logistic"):
            spec = arts[(kind, tag)].extras["emit_spec"]
            bits = spec["in_fmt"].total_bits
            for m in TIMED_BATCHES:
                qx = K.fxp.quantize(torch.from_numpy(x_big[:m]).cuda(),
                                    spec["in_fmt"])
                record = tag == "fxp16" and m == n_test
                if kind == "mlp":
                    ws = [torch.from_numpy(w).cuda() for w in spec["ws"]]
                    bs = [torch.from_numpy(b).cuda() for b in spec["bs"]]
                    sched = tuple(zip(spec["shifts"], spec["out_fmts"],
                                      spec["acts"]))
                    kern = lambda: K.model.fxp_mlp_model_cuda(qx, ws, bs,
                                                              sched)
                    plain = lambda: K.model.fxp_mlp_model_plain(qx, ws, bs,
                                                                sched)
                    out = kern()
                    macs = m * sum(w.shape[0] * w.shape[1] for w in ws)
                    nbytes = _nbytes(qx, *ws, *bs, out)
                    T.time("fxp_mlp_model", tag, m, kern, plain, nbytes,
                           2 * macs, T.dev.mma_peak(bits), record,
                           "fxp_mlp_model.cu", K.model.REPLACES,
                           profile=m >= n_test)
                    log_cuda_core_bound(T.dev, nbytes, 2 * macs, bits)
                else:
                    w = torch.from_numpy(spec["w"]).cuda()
                    b = torch.from_numpy(spec["b"]).cuda()
                    fmt, sh = spec["out_fmt"], spec["shift"]
                    kern = lambda: K.layer.fxp_layer_cuda(qx, w, b, fmt,
                                                          "none", sh)
                    plain = lambda: K.layer.fxp_layer_plain(qx, w, b, fmt,
                                                            "none", sh)
                    out = kern()
                    T.time("fxp_layer", tag, m, kern, plain,
                           _nbytes(qx, w, b, out), 2 * m * w.numel(),
                           T.dev.int_peak(bits), record, "fxp_layer.cu",
                           K.layer.REPLACES,
                           profile=tag == "fxp16" and m >= n_test)


def time_layer_wide(torch, K, T, arts, x_big, n_test):
    """fxp_layer's wide route (the integer tile shared with fxp_qmatmul) at
    the per-layer MLP route's first layer, 561 x 64, with its activation."""
    for tag in ("fxp16", "auto8", "fxp32"):
        spec = arts[("mlp", tag)].extras["emit_spec"]
        bits = spec["in_fmt"].total_bits
        w = torch.from_numpy(spec["ws"][0]).cuda()
        b = torch.from_numpy(spec["bs"][0]).cuda()
        layer = (spec["out_fmts"][0], spec["acts"][0], spec["shifts"][0])
        for m in (n_test, max(TIMED_BATCHES)):
            qx = K.fxp.quantize(torch.from_numpy(x_big[:m]).cuda(),
                                spec["in_fmt"])
            kern = lambda: K.layer.fxp_layer_cuda(qx, w, b, *layer)
            plain = lambda: K.layer.fxp_layer_plain(qx, w, b, *layer)
            out = kern()
            T.time("fxp_layer", f"{tag} 561x64", m, kern, plain,
                   _nbytes(qx, w, b, out), 2 * m * w.numel(),
                   T.dev.tile_peak(bits), False, "fxp_layer.cu",
                   K.layer.REPLACES, profile=True)


def path_steps(torch, tree, x):
    """Node compares the rows ``x`` (on the card; float32 or a container,
    cast as the kernel casts) need: the depth of the leaf each row
    reaches."""
    x = x.to(torch.float32)
    feat = torch.from_numpy(tree.feature.astype(np.int64)).to(x.device)
    thr = torch.from_numpy(tree.threshold.astype(np.float32)).to(x.device)
    left = torch.from_numpy(tree.left.astype(np.int64)).to(x.device)
    right = torch.from_numpy(tree.right.astype(np.int64)).to(x.device)
    node = torch.zeros(x.shape[0], dtype=torch.int64, device=x.device)
    steps = 0
    for _ in range(tree.n_nodes):
        f = feat[node]
        inner = f >= 0
        if not bool(inner.any()):
            break
        steps += int(inner.sum())
        xv = torch.gather(x, 1, f.clamp_min(0)[:, None])[:, 0]
        nxt = torch.where(xv <= thr[node], left[node], right[node])
        node = torch.where(inner, nxt, node)
    return steps


def time_tree_svm(torch, K, T, arts, tree_model, x_big, n_test):
    for tag in ("fxp16", "auto8", "fxp32", "flt"):
        # tree_ensemble: quantized rows cast to float32, or float rows
        art = arts[("tree", "D6", tag)]
        spec = art.extras.get("emit_spec")
        tree = tree_model.tree if spec is None else K.trees.TreeArrays(
            spec["feature"], spec["threshold"], spec["left"], spec["right"],
            spec["leaf_class"], spec["max_depth"], tree_model.tree.n_classes,
            tree_model.tree.n_features)
        node_bytes = 16 * tree.n_nodes  # one 16-byte record a node
        for m in TIMED_BATCHES:
            x = torch.from_numpy(x_big[:m]).cuda()
            if spec is not None:  # the container, as the lowering passes it
                x = K.fxp.quantize(x, spec["in_fmt"])
            kern = lambda: K.te.tree_ensemble_cuda(tree, x)
            plain = lambda: K.te.tree_ensemble_plain(tree, x)
            out = kern()
            steps = path_steps(torch, tree, x)
            if spec is None:
                # float32 rows are read whole (F finiteness tests each),
                # then one compare per node on each row's path
                ops, row_bytes = m * x.shape[1] + steps, _nbytes(x)
            else:
                # a container: the features on the path, one 32-byte
                # sector each
                ops, row_bytes = steps, 32 * steps
            T.time("tree_ensemble", tag, m, kern, plain,
                   row_bytes + _nbytes(out) + node_bytes, ops,
                   FP32_OPS_PER_S, tag == "fxp16" and m == n_test,
                   "tree_ensemble.cu", K.te.REPLACES,
                   profile=m >= n_test)
        if tag == "flt":
            continue
        # fxp_svm_model (rbf and poly) and the per-layer fxp_qmatmul
        for kind in ("svm-rbf", "svm-poly"):
            spec = arts[(kind, "D6", tag)].extras["emit_spec"]
            fmt, bits = spec["fmt"], spec["fmt"].total_bits
            sv, dual, b = (torch.from_numpy(spec[k]).cuda()
                           for k in ("sv", "dual", "b"))
            svt = sv.T.contiguous()
            (s, f), c = sv.shape, dual.shape[1]
            args = (spec["kernel"], fmt, spec["out_fmt"], spec["qgamma"],
                    spec["qcoef0"], spec["degree"], spec["dec_shift"])
            for m in TIMED_BATCHES:
                qx = K.fxp.quantize(torch.from_numpy(x_big[:m]).cuda(), fmt)
                kern = lambda: K.model.fxp_svm_model_cuda(qx, sv, dual, b,
                                                          *args)
                plain = lambda: K.model.fxp_svm_model_plain(qx, sv, dual, b,
                                                            *args)
                out = kern()
                T.time("fxp_svm_model", f"{tag} {kind[4:]}", m, kern, plain,
                       _nbytes(qx, sv, dual, b, out),
                       2 * m * (f * s + s * c), T.dev.int_peak(bits),
                       kind == "svm-rbf" and tag == "fxp16" and m == n_test,
                       "fxp_svm_model.cu", K.model.SVM_REPLACES,
                       profile=kind == "svm-rbf" and tag == "fxp16")
                if kind != "svm-rbf":
                    continue
                kern = lambda: K.qm.fxp_qmatmul_cuda(qx, svt, fmt)
                plain = lambda: K.qm.fxp_qmatmul_plain(qx, svt, fmt)
                out = kern()
                T.time("fxp_qmatmul", tag, m, kern, plain,
                       _nbytes(qx, svt, out), 2 * m * f * s,
                       T.dev.tile_peak(bits), tag == "fxp16" and m == n_test,
                       "fxp_qmatmul.cu", K.qm.REPLACES, profile=m >= n_test)
                if tag != "fxp16" or m < n_test:
                    continue
                # the per-layer route's decision stage: fxp_layer on the
                # (m, 300) kernel values and the (300, 6) duals
                kv = K.kref.svm_kernel_values(
                    out, qx, sv, "rbf", fmt, spec["qgamma"], spec["qcoef0"],
                    spec["degree"])
                dec = (spec["out_fmt"], "none", spec["dec_shift"])
                kern = lambda: K.layer.fxp_layer_cuda(kv, dual, b, *dec)
                plain = lambda: K.layer.fxp_layer_plain(kv, dual, b, *dec)
                out = kern()
                T.time("fxp_layer", f"{tag} svm-dec", m, kern, plain,
                       _nbytes(kv, dual, b, out), 2 * m * s * c,
                       T.dev.int_peak(bits), False, "fxp_layer.cu",
                       K.layer.REPLACES, profile=True)


def time_predict(art, x_big, what):
    for m in (TIMED_BATCHES[-2], TIMED_BATCHES[-1]):
        xb = x_big[:m]
        art.predict(xb)
        times = []
        for _ in range(10):
            t0 = time.perf_counter()
            art.predict(xb)
            times.append(time.perf_counter() - t0)
        ms = float(np.median(times)) * 1e3
        log(f"  predict {what:24s} batch {m:6d}: {ms:8.3f} ms, "
            f"{m / ms * 1e3:12.0f} rows/s")


def predict_breakdown(torch, K, art, x_big, batches, pinned=False):
    """Where one megakernel predict spends its time: each stage of
    ``predict`` run alone between synchronizations, host clock, median.
    ``pinned`` hands the rows over as the serving plane's staging buffer
    does (a pinned host tensor, copied without blocking); otherwise as a
    pageable numpy array."""
    spec = art.extras["emit_spec"]
    ws = [torch.from_numpy(w).cuda() for w in spec["ws"]]
    bs = [torch.from_numpy(b).cuda() for b in spec["bs"]]
    sched = tuple(zip(spec["shifts"], spec["out_fmts"], spec["acts"]))
    for m in batches:
        xb = np.ascontiguousarray(x_big[:m])
        if pinned:
            xb = torch.from_numpy(xb).pin_memory()
        state = {}
        stages = (
            ("copy rows to card", lambda: state.update(
                x=K.common.as_input(xb, art.device))),
            ("quantize + stats", lambda: state.update(
                q=K.fxp.quantize_with_stats(state["x"], spec["in_fmt"])[0])),
            ("fxp_mlp_model kernel", lambda: state.update(
                out=K.model.fxp_mlp_model_cuda(state["q"], ws, bs, sched))),
            ("argmax", lambda: state.update(
                lab=K.common.argmax_first(state["out"]))),
            ("copy labels to host", lambda: state["lab"].cpu().numpy()),
        )
        times = {name: [] for name, _ in stages}
        for _ in range(11):
            for name, fn in stages:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                times[name].append((time.perf_counter() - t0) * 1e3)
        parts = ", ".join(f"{name} {float(np.median(t)):.3f}"
                          for name, t in times.items())
        log(f"  predict stages, mlp {art.target.number_format}, batch {m}, "
            f"{'pinned' if pinned else 'pageable'} rows (ms): {parts}")


def tree_predict_kernels(torch, K, art, x):
    """The device work of one quantized tree predict, beside the route of
    the port's first tree lowering (quantize, cast to float32, the kernel on
    the float rows), which the kernel's container input replaced."""
    spec = art.extras["emit_spec"]
    tree = K.trees.TreeArrays(
        spec["feature"], spec["threshold"], spec["left"], spec["right"],
        spec["leaf_class"], spec["max_depth"], 0, x.shape[1])
    xt = torch.from_numpy(x).cuda()
    routes = (
        ("predict", lambda: art.predict(x)),
        ("quantize + kernel on the container", lambda: K.te.tree_ensemble_cuda(
            tree, K.fxp.quantize_with_stats(xt, spec["in_fmt"])[0])),
        ("quantize + cast + kernel on float32 rows (the first lowering)",
         lambda: K.te.tree_ensemble_cuda(tree, K.fxp.quantize_with_stats(
             xt, spec["in_fmt"])[0].to(torch.float32))))
    for what, fn in routes:
        fn()
        prof = _kernel_profile(torch, fn)
        log(f"  tree {art.target.number_format} {what}, {len(x)} rows: "
            f"{prof['launches']} kernel launches, "
            f"{sum(prof['by_kind'].values()):.4f} ms device")


def _stacked(torch, arrays):
    return torch.stack([torch.from_numpy(a) for a in arrays]).cuda()


def time_slice(torch, K, T, arts_d, d6, d5):
    """The new kernels at the main paths' shapes: pwl_activation on the D6
    MLP's (rows, 64) hidden layer, fxp_mlp_fleet over the 8 D6 MLPs of
    path D, fxp_svm_fleet over its 4 D5 rbf SVMs, at 3089/3298 rows and
    65536; eight fxp_mlp_model launches beside the one fleet launch."""
    mlp = K.models.init_mlp([561, 64, 6], seed=0)
    w0 = torch.from_numpy(mlp.weights[0]).cuda()
    b0 = torch.from_numpy(mlp.biases[0]).cuda()
    for m in (len(d6.x_test), max(TIMED_BATCHES)):
        x = torch.from_numpy(np.resize(d6.x_test, (m, 561))).cuda()
        acc = x @ w0
        for v in ("pwl4", "rational"):
            # path C's hidden layer: the bias add in the kernel's launch
            kern = lambda: K.pwl.pwl_activation_cuda(acc, v, bias=b0)
            plain = lambda: K.pwl.pwl_activation_plain(acc, v, bias=b0)
            out = kern()
            T.time("pwl_activation", f"{v}+bias", m, kern, plain,
                   _nbytes(acc, b0, out), 9 * acc.numel(), FP32_OPS_PER_S,
                   v == "pwl4" and m == len(d6.x_test), "pwl_activation.cu",
                   K.pwl.REPLACES, profile=True,
                   shape=f"{v}(acc + bias) on the D6 MLP's ({m}, 64) hidden "
                         f"layer (path C)")
            unfused = lambda: K.pwl.pwl_activation_cuda(acc + b0, v)
            ms, host = cuda_ms(torch, unfused, 200 if m <= 3298 else 20)
            log(f"  {'':14s} the unfused pair (bias add, then the kernel "
                f"without bias): {ms:.4f} ms, host {host:.4f}, profiler "
                f"device {device_ms(torch, unfused):.4f}")
    specs = [arts_d[f"mlp{s}"].extras["emit_spec"] for s in range(8)]
    ws = [_stacked(torch, [sp["ws"][i] for sp in specs]) for i in range(2)]
    bs = [_stacked(torch, [sp["bs"][i] for sp in specs]) for i in range(2)]
    scheds = tuple(tuple(zip(sp["shifts"], sp["out_fmts"], sp["acts"]))
                   for sp in specs)
    bits = specs[0]["in_fmt"].total_bits
    for m in (len(d6.x_test), max(TIMED_BATCHES)):
        xf = torch.from_numpy(np.resize(d6.x_test, (m, 561))).cuda()
        qx = torch.stack([K.fxp.quantize(xf, sp["in_fmt"]) for sp in specs])
        kern = lambda: K.model.fxp_mlp_fleet_cuda(qx, ws, bs, scheds)
        plain = lambda: K.model.fxp_mlp_fleet_plain(qx, ws, bs, scheds)
        out = kern()
        macs = 8 * m * sum(w.shape[1] * w.shape[2] for w in ws)
        nbytes = _nbytes(qx, *ws, *bs, out)
        ms = T.time("fxp_mlp_fleet", "auto16 E=8", m, kern, plain,
                    nbytes, 2 * macs, T.dev.mma_peak(bits),
                    m == len(d6.x_test), "fxp_mlp_fleet.cu",
                    K.model.MLP_FLEET_REPLACES,
                    shape=f"8 D6 MLPs (auto16, per-model schedules) x {m} "
                          f"rows", profile=True)
        log_cuda_core_bound(T.dev, nbytes, 2 * macs, bits)
        solo = lambda: [K.model.fxp_mlp_model_cuda(
            qx[e], [w[e] for w in ws], [b[e] for b in bs], scheds[e])
            for e in range(8)]
        solo_ms, solo_host = cuda_ms(torch, solo, 50 if m <= 3298 else 5)
        log(f"  8 x fxp_mlp_model at {m} rows: {solo_ms:.4f} ms device "
            f"({solo_host:.4f} ms host) against one fxp_mlp_fleet launch "
            f"{ms:.4f} ms")
    specs = [arts_d[f"rbf{s}"].extras["emit_spec"] for s in range(4)]
    sv, dual, icept = (_stacked(torch, [sp[k] for sp in specs])
                       for k in ("sv", "dual", "b"))
    params = tuple((sp["fmt"], sp["out_fmt"], sp["qgamma"], sp["qcoef0"],
                    sp["degree"], sp["dec_shift"]) for sp in specs)
    (s_, f_), c_ = sv.shape[1:], dual.shape[2]
    for m in (64, len(d5.x_test), max(TIMED_BATCHES)):
        xf = torch.from_numpy(np.resize(d5.x_test, (m, f_))).cuda()
        qx = K.fxp.quantize(xf, specs[0]["fmt"]).expand(4, m, f_).contiguous()
        kern = lambda: K.model.fxp_svm_fleet_cuda(qx, sv, dual, icept, "rbf",
                                                  params)
        plain = lambda: K.model.fxp_svm_fleet_plain(qx, sv, dual, icept,
                                                    "rbf", params)
        out = kern()
        ms = T.time("fxp_svm_fleet", "fxp32 E=4", m, kern, plain,
                    _nbytes(qx, sv, dual, icept, out),
                    2 * 4 * m * (f_ * s_ + s_ * c_), T.dev.int_peak(32),
                    m == len(d5.x_test), "fxp_svm_fleet.cu",
                    K.model.SVM_FLEET_REPLACES,
                    shape=f"4 D5 rbf SVMs (fxp32, S={s_}) x {m} rows",
                    profile=True)
        solo = lambda: [K.model.fxp_svm_model_cuda(
            qx[e], sv[e], dual[e], icept[e], "rbf", *params[e])
            for e in range(4)]
        solo_ms, solo_host = cuda_ms(torch, solo, 50 if m <= 3298 else 5)
        log(f"  4 x fxp_svm_model at {m} rows: {solo_ms:.4f} ms "
            f"({solo_host:.4f} ms host; profiler device "
            f"{device_ms(torch, solo):.4f}) against one fxp_svm_fleet "
            f"launch {ms:.4f} ms")


def time_predict_device(torch, K, arts_d, d6):
    """Host time of FleetStack.predict_device beside the device time of
    the work it enqueues: a hidden synchronization would make the two
    equal."""
    stack = K.tc.stack_fleet([arts_d[f"mlp{s}"] for s in range(8)])
    for m in (64, 4096):
        buf = torch.from_numpy(np.ascontiguousarray(np.broadcast_to(
            np.resize(d6.x_test, (m, 561)), (8, m, 561)))).pin_memory()
        stack.predict_device(buf).cpu()
        host, total = [], []
        for _ in range(7):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = stack.predict_device(buf)
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            host.append((t1 - t0) * 1e3)
            total.append((t2 - t0) * 1e3)
        del out
        log(f"  FleetStack.predict_device, 8 D6 MLPs x {m} rows (pinned "
            f"{buf.numel() * 4 / 1e6:.1f} MB): host {np.median(host):.3f} "
            f"ms, until the card is done {np.median(total):.3f} ms")


def serving_record(torch, K, arts_d, rows):
    """The first serving record: 8 D6 MLP endpoints, 8 client threads each
    sending its endpoint 500 one-row requests, one in flight at a time,
    BatchingPolicy(max_batch=64, max_wait_ms=2.0), fleet off and on."""
    S = K.serve
    x = np.resize(rows, (500, 561))
    names = [f"mlp{s}" for s in range(8)]
    for fleet in (False, True):
        svc = S.InferenceService()
        try:
            for n in names:
                svc.register(n, artifact=arts_d[n],
                             policy=S.BatchingPolicy(max_batch=64,
                                                     max_wait_ms=2.0))
            if fleet and len(svc.enable_fleet()) != 1:
                raise AssertionError("the 8 MLPs did not form one fleet")
            for n in names:  # warm every bucket (and the stack) first
                svc.submit(n, x[:1]).result(timeout=300)
            lat = [[] for _ in names]

            def client(i):
                for r in range(500):
                    t0 = time.perf_counter()
                    svc.submit(names[i], x[r:r + 1]).result(timeout=300)
                    lat[i].append(time.perf_counter() - t0)

            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(8)]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join(600)
            wall = time.perf_counter() - t0
            if any(t.is_alive() for t in threads):
                raise AssertionError("a serving client did not finish")
            stats = svc.stats()
        finally:
            svc.close()
        ms = np.concatenate(lat) * 1e3
        if fleet:
            co = stats["_fleets"][0]
            extra = (f"fleet rounds {co['rounds']}, stack fallbacks "
                     f"{co['stack_fallbacks']}, coalescer assembly_s "
                     f"{co['assembly_s']:.4f}, device_s {co['device_s']:.4f}")
            if co["stack_fallbacks"] != 0:
                raise AssertionError(f"serving record: {co}")
        else:
            extra = ("endpoints' assembly_s "
                     f"{sum(stats[n]['assembly_s'] for n in names):.4f}, "
                     f"device_s {sum(stats[n]['device_s'] for n in names):.4f}"
                     f", staging allocs "
                     f"{[stats[n]['n_staging_allocs'] for n in names]}")
        log(f"  serving 8 MLP endpoints, fleet {'on ' if fleet else 'off'}: "
            f"{len(ms) / wall:.0f} requests/s, p50 "
            f"{np.percentile(ms, 50):.3f} ms, p99 {np.percentile(ms, 99):.3f}"
            f" ms over {len(ms)} requests in {wall:.2f} s; {extra}")


def _kernel_profile(torch, fn):
    """Device time by kernel kind and by name (ms), the number of kernel
    launches (the host's launch calls) and of device activities (kernels
    and copies, and their count by name) of one call of ``fn``, from
    torch.profiler's CPU and CUDA activity."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_kind = {"flash_attention": 0.0, "pwl_activation": 0.0,
               "float32 GEMM": 0.0, "bf16 GEMM": 0.0, "other": 0.0}
    launches = activities = 0
    names, device_ms = {}, {}
    for e in prof.key_averages():
        if e.key in ("cudaLaunchKernel", "cuLaunchKernelEx", "cuLaunchKernel",
                     "cudaLaunchKernelExC"):
            launches += e.count
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        activities += e.count
        names[e.key] = e.count
        device_ms[e.key] = e.self_device_time_total / 1e3
        name = e.key
        ms = e.self_device_time_total / 1e3
        if "flash_attention_kernel" in name:
            by_kind["flash_attention"] += ms
        elif "pwl_activation_kernel" in name:
            by_kind["pwl_activation"] += ms
        elif "f32f32" in name or ("gemm" in name and "f32" in name):
            by_kind["float32 GEMM"] += ms
        elif any(t in name for t in ("gemm", "nvjet", "cutlass", "xmma")):
            by_kind["bf16 GEMM"] += ms
        else:
            by_kind["other"] += ms
    return {"by_kind": by_kind, "launches": launches,
            "activities": activities, "names": names,
            "device_ms": device_ms}


def time_lm(torch, K, T, lm):
    """Path E's kernel at the prefill's shape — qwen2-0.5b's 14 heads x
    batch 4, 2048 tokens, dh 64, bf16, causal — beside its plain version,
    its bound and one PyTorch call that computes the same function
    (scaled_dot_product_attention, a yardstick the port never calls); then
    the whole prefill forward with the kernel's share of it, and decode
    ms/token at both served targets."""
    fa, M = K.fa, K.lm_model
    cfg, params = lm["cfg"], lm["params"]
    h, dh, s = cfg.n_heads, cfg.head_dim, LM_SEQ
    hkv, group = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads
    bh = LM_BATCH * h
    gen = torch.Generator(device="cuda").manual_seed(3)
    q, k, v = (torch.randn(bh, s, dh, generator=gen, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    # the grouped form path E launches: K/V of the 4 x 2 KV heads
    kg, vg = (t.view(LM_BATCH, h, s, dh)[:, ::group].reshape(
        LM_BATCH * hkv, s, dh).contiguous() for t in (k, v))
    pairs = s * (s + 1) // 2  # the causal (query, key) pairs this run needs
    flops = 4 * bh * dh * pairs
    out = fa.flash_attention_cuda(q, k, v, True)
    ungrouped_ms = T.time("flash_attention", "bf16 G=1", s,
                          lambda: fa.flash_attention_cuda(q, k, v, True),
                          lambda: fa.flash_attention_plain(q, k, v, True),
                          _nbytes(q, k, v, out), flops, BF16_TENSOR_OPS_PER_S,
                          False, "flash_attention.cu", fa.REPLACES)
    outg = fa.flash_attention_cuda(q, kg, vg, True)
    kern_ms = T.time("flash_attention", f"bf16 G={group}", s,
                     lambda: fa.flash_attention_cuda(q, kg, vg, True),
                     lambda: fa.flash_attention_plain(q, kg, vg, True),
                     _nbytes(q, kg, vg, outg), flops, BF16_TENSOR_OPS_PER_S,
                     True, "flash_attention.cu", fa.REPLACES,
                     shape=f"(BH {bh} = batch {LM_BATCH} x {h} heads, K/V "
                           f"{LM_BATCH * hkv} rows (G {group}), S {s}, dh "
                           f"{dh}) bf16 causal: one layer of the {LM_ARCH} "
                           f"prefill")
    q4, k4, v4 = (t.view(LM_BATCH, -1, s, dh) for t in (q, k, v))
    kg4, vg4 = (t.view(LM_BATCH, hkv, s, dh) for t in (kg, vg))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_ms, _ = cuda_ms(torch, lambda: sdpa(q4, k4, v4, is_causal=True), 200)
    lib_g_ms, _ = cuda_ms(torch, lambda: sdpa(q4, kg4, vg4, is_causal=True,
                                              enable_gqa=True), 200)
    err = float((sdpa(q4, k4, v4, is_causal=True).reshape(bh, s, dh).float()
                 - out.float()).abs().max())
    err_g = float((sdpa(q4, kg4, vg4, is_causal=True, enable_gqa=True)
                   .reshape(bh, s, dh).float() - outg.float()).abs().max())
    T.records["flash_attention"]["library_ms"] = lib_g_ms
    T.records["flash_attention"]["ungrouped_ms"] = ungrouped_ms
    T.records["flash_attention"]["ungrouped_library_ms"] = lib_ms
    log(f"  scaled_dot_product_attention (library yardstick) on the same "
        f"tensors: {lib_ms:.4f} ms ungrouped (max abs diff from the kernel "
        f"{err:.3e}; kernel / library {ungrouped_ms / lib_ms:.2f}x), "
        f"{lib_g_ms:.4f} ms with enable_gqa (max abs diff {err_g:.3e}; "
        f"kernel / library {kern_ms / lib_g_ms:.2f}x); kernel at "
        f"{flops / kern_ms / 1e9:.1f} Tflop/s")
    del q, k, v, kg, vg, out, outg, q4, k4, v4, kg4, vg4
    tok = _lm_tokens(torch, cfg, (LM_BATCH, LM_SEQ), 0)
    fwd_ms, fwd_host = cuda_ms(torch, lambda: M.forward(params,
                                                        {"tokens": tok}, cfg), 5)
    ref_ms, _ = cuda_ms(torch, lambda: M.forward(
        params, {"tokens": tok}, cfg, attn_impl="ref"), 3)
    body = cfg.param_count() - cfg.vocab_size * cfg.d_model  # minus the table
    n_tok = LM_BATCH * LM_SEQ
    flops = (2 * n_tok * body + 2 * n_tok * cfg.d_model * cfg.vocab_size
             + cfg.n_layers * 4 * LM_BATCH * h * dh * pairs)
    log(f"  prefill forward {LM_BATCH} x {LM_SEQ} bf16: {fwd_ms:.3f} ms "
        f"({fwd_host:.3f} ms host); flash_attention {cfg.n_layers} x "
        f"{kern_ms:.4f} = {cfg.n_layers * kern_ms:.3f} ms, "
        f"{cfg.n_layers * kern_ms / fwd_ms:.1%} of it; bound "
        f"{flops / BF16_TENSOR_OPS_PER_S * 1e3:.3f} ms ({flops / 1e12:.3f} "
        f"Tflop at the bf16 tensor-core rate); with the oracle's attention "
        f"in place of the kernel: {ref_ms:.3f} ms")
    prefill = _kernel_profile(torch, lambda: M.forward(params,
                                                       {"tokens": tok}, cfg))
    total = sum(prefill["by_kind"].values())
    log(f"  prefill forward by kernel kind (torch.profiler, device time): "
        + ", ".join(f"{k} {v:.3f} ms ({v / total:.1%})"
                    for k, v in prefill["by_kind"].items())
        + f"; {prefill['launches']} launches")
    cache = M.init_cache(cfg, LM_GEN_BATCH, 8, tok.device)
    step = _kernel_profile(torch, lambda: M.serve_step(
        params, cache, {"token": tok[:LM_GEN_BATCH, 0]}, cfg))
    log(f"  one flt decode step, batch {LM_GEN_BATCH}: "
        f"{sum(step['by_kind'].values()):.3f} ms of device time in "
        f"{step['launches']} launches (host-bound when ms/token is above "
        f"it)")
    for name, st in lm["serving"].items():
        log(f"  decode {name}: {st['ms_per_token']:.3f} ms/token at batch "
            f"{LM_GEN_BATCH} (host clock over {LM_GEN_TOKENS} tokens); "
            f"weights read per token {st['flash_bytes']} bytes, bound "
            f"{st['flash_bytes'] / HBM_BYTES_PER_S * 1e3:.4f} ms")


def time_lm_gate(torch, K, T, lm):
    """Path E's pwl4 SiLU gate: the kernel (silu_pwl4) at the decode (4,
    4864) and bf16 prefill (4 x 2048, 4864) shapes beside its plain version,
    its bytes bound and the op-by-op gate it replaced; a bf16 prefill
    forward at the pwl4 gate and one decode step of the served
    fxp8/qnm/int8-KV/pwl4 artifact by torch.profiler, with the gate through
    the kernel and op by op; and decode ms/token of that artifact with the
    two gate routes in turns (op by op, kernel, kernel, op by op)."""
    M, cfg, params = K.lm_model, lm["cfg"], lm["params"]
    gen = torch.Generator(device="cuda").manual_seed(4)
    for rows, what in ((LM_GEN_BATCH, "decode"),
                       (LM_BATCH * LM_SEQ, "bf16 prefill")):
        x = (torch.randn(rows, cfg.d_ff, generator=gen, device="cuda")
             * 4).to(torch.bfloat16)
        kern = lambda: K.pwl.pwl_activation_cuda(x, "silu_pwl4")
        plain = lambda: K.pwl.pwl_activation_plain(x, "silu_pwl4")
        out = kern()
        T.time("pwl_activation", "silu_pwl4", rows, kern, plain,
               _nbytes(x, out), 8 * x.numel(), FP32_OPS_PER_S, False,
               "pwl_activation.cu", K.pwl.REPLACES, profile=True)
        eager = lambda: x * K.acts.sigmoid_pwl4(x)
        ms, host = cuda_ms(torch, eager, 200 if rows <= 3298 else 20)
        prof = _kernel_profile(torch, eager)
        log(f"  {'':14s} the op-by-op gate x * sigmoid_pwl4(x) at the "
            f"{what} shape ({rows}, {cfg.d_ff}) bf16: {ms:.4f} ms, host "
            f"{host:.4f}, {prof['launches']} launches, "
            f"{sum(prof['by_kind'].values()):.4f} ms device")
    tok = _lm_tokens(torch, cfg, (LM_BATCH, LM_SEQ), 0)
    cfg_g = dataclasses.replace(cfg, gate_sigmoid="pwl4")
    gate_bytes = 2 * LM_BATCH * LM_SEQ * cfg.d_ff * 2  # bf16 in and out
    for kernel in (False, True):
        with gate_route(K, kernel):
            prof = _kernel_profile(torch, lambda: M.forward(
                params, {"tokens": tok}, cfg_g))
        by = prof["by_kind"]
        route = "through the kernel" if kernel else "op by op"
        log(f"  prefill forward {LM_BATCH} x {LM_SEQ} bf16 at the pwl4 "
            f"gate, gate {route}: "
            f"{prof['launches']} launches, {prof['activities']} device "
            f"activities, {sum(by.values()):.3f} ms device; pwl_activation "
            f"{by['pwl_activation']:.4f} ms = {cfg.n_layers} x "
            f"{by['pwl_activation'] / cfg.n_layers:.4f} ms a layer (bytes "
            f"bound {gate_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms a layer); "
            f"other {by['other']:.3f} ms")
    art = lm["serving"]["fxp8_qnm_kv8_pwl4"]["artifact"]
    acfg, ap = art.extras["cfg"], art.extras["params"]
    cache = M.init_cache(acfg, LM_GEN_BATCH, 8, tok.device)
    for kernel in (False, True):
        with gate_route(K, kernel):
            step = _kernel_profile(torch, lambda: M.serve_step(
                ap, cache, {"token": tok[:LM_GEN_BATCH, 0]}, acfg))
        route = "through the kernel" if kernel else "op by op"
        log(f"  one fxp8/qnm/int8-KV/pwl4 decode step, batch "
            f"{LM_GEN_BATCH}, gate {route}: "
            f"{step['launches']} launches, {step['activities']} device "
            f"activities, {sum(step['by_kind'].values()):.3f} ms device")
    start = np.random.RandomState(2).randint(
        1, cfg.vocab_size, (LM_GEN_BATCH,)).astype(np.int32)
    readings = {False: [], True: []}
    turns = (False, True, True, False) * 2
    for kernel in turns:
        with gate_route(K, kernel):
            art.extras["generate"](start, 2)
            t0 = time.perf_counter()
            art.extras["generate"](start, LM_GEN_TOKENS)
            readings[kernel].append(
                (time.perf_counter() - t0) * 1e3 / LM_GEN_TOKENS)
    order = {False: iter(readings[False]), True: iter(readings[True])}
    log(f"  decode fxp8/qnm/int8-KV/pwl4 ms/token at batch {LM_GEN_BATCH} "
        f"(host clock over {LM_GEN_TOKENS} tokens), the gate op by op (o) "
        f"and through the kernel (k) in turns: "
        + " / ".join(f"{'k' if k else 'o'} {next(order[k]):.3f}"
                     for k in turns)
        + f"; median o {np.median(readings[False]):.3f}, k "
        f"{np.median(readings[True]):.3f}")


@contextlib.contextmanager
def unfused_bias():
    """Path C's lowering with the bias add outside the kernel's launch (the
    route before the fused bias): ``ops.pwl_activation`` adds it first."""
    from repro_torch.kernels import ops

    fused = ops.pwl_activation

    def unfused(x, variant="pwl4", impl="cuda", bias=None):
        return fused(x if bias is None else x + bias, variant, impl)

    ops.pwl_activation = unfused
    try:
        yield
    finally:
        ops.pwl_activation = fused


def flt_pwl_predict(torch, K, x_big):
    """Path C's predict (the flt D6 MLP, pwl4 sigmoid, ``cuda``) at 1, 64,
    3089 and 65536 rows: its device activities, kernel launches and device
    time by kernel (its stages) by torch.profiler, beside the same lowering
    with the bias added outside the kernel (labels equal), and both
    predicts end to end (host clock, median of 10)."""
    mlp = K.models.init_mlp([561, 64, 6], seed=0)
    art = K.tc.compile(mlp, K.tc.Target(sigmoid="pwl4", backend="cuda"))

    def median_ms(fn, n):
        fn()
        times = []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(times))

    for m in TIMED_BATCHES:
        xb = np.ascontiguousarray(x_big[:m])
        fused_p = _kernel_profile(torch, lambda: art.predict(xb))
        fused_ms = median_ms(lambda: art.predict(xb), 10)
        with unfused_bias():
            unfused_labels = art.predict(xb)
            unfused_p = _kernel_profile(torch, lambda: art.predict(xb))
            unfused_ms = median_ms(lambda: art.predict(xb), 10)
        if not np.array_equal(art.predict(xb), unfused_labels):
            raise AssertionError(f"path C, {m} rows: the fused bias changes "
                                 f"labels")
        if unfused_p["launches"] != fused_p["launches"] + 1:
            raise AssertionError(f"path C, {m} rows: {fused_p['launches']} "
                                 f"launches with the fused bias, "
                                 f"{unfused_p['launches']} without: not one "
                                 f"fewer")
        stages = ", ".join(f"{name[:48]} {ms:.4f}"
                           for name, ms in fused_p["device_ms"].items())
        log(f"  path C predict, flt pwl4 MLP, batch {m}: fused bias "
            f"{fused_p['activities']} device activities "
            f"({fused_p['launches']} kernel launches), unfused "
            f"{unfused_p['activities']} ({unfused_p['launches']}); labels "
            f"equal; predict {fused_ms:.3f} ms, unfused {unfused_ms:.3f} "
            f"ms; device ms by kernel: {stages}")


def timing(torch, K, dev, d6, d5, check, arts_a, arts_b, arts_d, tree_model,
           launches, lm):
    x_big = np.resize(d6.x_test, (max(TIMED_BATCHES), d6.x_test.shape[1]))
    n_test = len(d6.x_test)
    T = Timer(torch, dev, check, launches)
    time_lm(torch, K, T, lm)
    time_lm_gate(torch, K, T, lm)
    time_mlp(torch, K, T, arts_a, x_big, n_test)
    time_tree_svm(torch, K, T, arts_b, tree_model, x_big, n_test)
    time_layer_wide(torch, K, T, arts_a, x_big, n_test)
    time_slice(torch, K, T, arts_d, d6, d5)
    time_predict_device(torch, K, arts_d, d6)
    flt_pwl_predict(torch, K, x_big)
    predict_breakdown(torch, K, arts_a[("mlp", "fxp16")], x_big,
                      (n_test, max(TIMED_BATCHES)))
    for pinned in (False, True):
        predict_breakdown(torch, K, arts_d["mlp0"], x_big, (64, 4096),
                          pinned=pinned)
    serving_record(torch, K, arts_d, d6.x_test)
    log("  predict end to end (host clock around predict -> numpy labels)")
    for tag in TAGS:
        for kind in ("mlp", "logistic"):
            time_predict(arts_a[(kind, tag)], x_big, f"{kind} {tag}")
    for key in (("tree", "D6", "fxp16"), ("tree", "D6", "flt"),
                ("svm-rbf", "D6", "fxp16"), ("svm-poly", "D6", "fxp16")):
        time_predict(arts_b[key], x_big, " ".join(key[::2]))
    tree_predict_kernels(torch, K, arts_b[("tree", "D6", "fxp16")],
                         d6.x_test)
    return [T.records[n] for n in KernelCheck.NAMES]


def check_tensor_core_sass(build):
    """Count the tensor-core MMA instructions in the SASS of each instance
    of the kernels in TENSOR_CORE_SASS (HMMA for bf16 flash_attention, IMMA
    for the 8- and 16-bit MLP megakernels), where the toolkit's cuobjdump
    exists; fail if an instance that must use the tensor cores has none."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.access(tool, os.X_OK):
        log("  cuobjdump not found: MMA counts not taken")
        return
    for lib, part, opcode in TENSOR_CORE_SASS:
        sass = subprocess.run([tool, "-sass", str(build._library_path(lib))],
                              capture_output=True, text=True, timeout=300,
                              check=True).stdout
        counts, fn = {}, None
        for line in sass.splitlines():
            if "Function :" in line:
                fn = line.split("Function :")[1].strip()
                counts[fn] = 0
            elif fn is not None and opcode in line:
                counts[fn] += 1
        for fn, n in counts.items():
            log(f"  SASS {lib} {fn}: {n} {opcode}")
        need = {fn: n for fn, n in counts.items() if part in fn}
        if not need or not all(need.values()):
            raise AssertionError(f"{lib} instances without {opcode} in their "
                                 f"SASS: {need}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke runs on a GPU host",
              file=sys.stderr)
        return 2
    from repro_torch import compile as tc
    from repro_torch import models
    from repro_torch.compile.lowerings import common
    from repro_torch.core import fixedpoint as fxp
    from repro_torch.core import trees
    from repro_torch.data import load_dataset
    from repro_torch import serve
    from repro_torch import configs
    from repro_torch import emit
    from repro_torch.kernels import (build, flash_attention, fxp_layer,
                                     fxp_model, fxp_qmatmul, pwl_activation,
                                     tree_ensemble, tune)
    from repro_torch.kernels import ref as kernels_ref
    from repro_torch.core import activations as acts
    from repro_torch.lm import layers as lm_layers
    from repro_torch.lm import model as lm_model
    from repro_torch.models.svm import _pick_prototypes
    from repro_torch.train import checkpoint as ckpt

    K = types.SimpleNamespace(
        tc=tc, models=models, common=common, fxp=fxp, trees=trees,
        layer=fxp_layer, model=fxp_model, qm=fxp_qmatmul, te=tree_ensemble,
        pwl=pwl_activation, serve=serve, pick_prototypes=_pick_prototypes,
        fa=flash_attention, lm_model=lm_model, lm_layers=lm_layers,
        acts=acts, emit=emit, ckpt=ckpt,
        configs=configs, tune=tune,
        kref=kernels_ref,
        launchers={"fxp_layer": fxp_layer.fxp_layer_cuda,
                   "fxp_mlp_model": fxp_model.fxp_mlp_model_cuda,
                   "fxp_qmatmul": fxp_qmatmul.fxp_qmatmul_cuda,
                   "fxp_svm_model": fxp_model.fxp_svm_model_cuda,
                   "tree_ensemble": tree_ensemble.tree_ensemble_cuda,
                   "pwl_activation": pwl_activation.pwl_activation_cuda,
                   "fxp_mlp_fleet": fxp_model.fxp_mlp_fleet_cuda,
                   "fxp_svm_fleet": fxp_model.fxp_svm_fleet_cuda,
                   "flash_attention": flash_attention.flash_attention_cuda})

    t_start = time.perf_counter()
    dev = Device(torch)

    t0 = time.perf_counter()
    built = build.build_all()
    log(f"phase 2: built {list(built)} in {time.perf_counter() - t0:.1f} s "
        f"(per library: { {k: round(v, 1) for k, v in built.items()} })")
    for name, out in build.BUILD_LOG.items():
        for line in out.splitlines():
            if ("registers" in line or "spill" in line or "smem" in line
                    or (name in REDESIGNED and "entry function" in line)):
                log(f"  ptxas {name}: {line.strip()}")
    check_tensor_core_sass(build)
    t0 = time.perf_counter()
    d6, d5 = load_dataset("D6"), load_dataset("D5")
    log(f"  D6 and D5 generated in {time.perf_counter() - t0:.1f} s: D6 train "
        f"{d6.x_train.shape}, test {d6.x_test.shape}; D5 train "
        f"{d5.x_train.shape}, test {d5.x_test.shape}")
    t0 = time.perf_counter()
    tree_model = models.train_decision_tree(d6.x_train, d6.y_train,
                                            d6.n_classes, max_depth=TREE_DEPTH)
    log(f"  D6 tree trained in {time.perf_counter() - t0:.1f} s: "
        f"{tree_model.tree.n_nodes} nodes, {tree_model.tree.n_leaves} leaves")

    t0 = time.perf_counter()
    check = KernelCheck(torch, K)
    check.run(tree_model.tree, d6.x_test)
    log(f"  phase 3 took {time.perf_counter() - t0:.1f} s")

    arts_a, launches_a = main_path_mlp(torch, K, d6)
    arts_b, launches_b = main_path_tree_svm(torch, K, d6, d5, tree_model)
    emit_c_phase(K, arts_a, arts_b, d6, d5)
    launches_c = main_path_flt_pwl(torch, K, d6)
    launches_d, arts_d = main_path_serving(torch, K, d6, d5, tree_model)
    launches_e, lm = main_path_lm(torch, K)
    launches_g = main_path_pipeline(torch, K, d6, tree_model)
    by_path = {"A": launches_a, "B": launches_b, "C": launches_c,
               "D": launches_d, "E": launches_e, "G": launches_g}
    launches = {n: (sum(p[n] for p in by_path.values()),
                    {k: p[n] for k, p in by_path.items()})
                for n in KernelCheck.NAMES}
    kernels = timing(torch, K, dev, d6, d5, check, arts_a, arts_b, arts_d,
                     tree_model, launches, lm)
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(dev.smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev.name, "count": dev.count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
