#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (the port's quickest proof
that it still starts, builds and computes the right bits on the card).

    python3 chip_smoke.py

Phases, each of which raises on failure:

1. Device: the card's name, count and ``nvidia-smi`` name/power limit.
   Exits non-zero without a CUDA device.
2. Build every CUDA kernel of the main paths from ``src/repro_torch/kernels/
   csrc`` (five sources, one ``nvcc`` each, in parallel) and print the build
   time and ``ptxas`` resource lines.  Then the data: D6 ("har") and D5
   ("pendigits") from their seeds, and the D6 tree trained by the port's
   CART (``max_depth=12``).
3. Each kernel against its plain PyTorch version on the card, bit for bit,
   at the main paths' shapes, every container width, values at qmin/qmax,
   int32-wrapping sums and batches 1..65536:
   * ``fxp_layer`` (561x64, 64x6, 561x6 layers, every activation, shifts 0
     and width-1) and ``fxp_mlp_model`` (561->64->6);
   * ``fxp_qmatmul``: (M,561)x(561,300) and (M,8)x(8,300);
   * ``fxp_svm_model``: poly and rbf at the D6 shapes (S=300, F=561, C=6)
     and the D5 shapes (S=300, F=8, C=10), nonzero random q(gamma) and
     q(coef0), degrees 1-3;
   * ``tree_ensemble``: the trained D6 tree on float rows with NaN and
     +-inf values, and on fxp16/fxp32 rows.
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
   In both, labels equal the plain versions' on the card; the rows where
   ``ref`` and ``cuda`` differ are printed as information.
5. Timing with CUDA events after warm-up: each kernel and its plain version
   at batches 1, 64, 3089 and 65536, beside the bound, and ``predict`` end
   to end.

The lines before the last are a JSON ``{"kernels": [...]}`` record and the
``nvidia-smi`` name/power-limit line; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
import types

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
INT8_TENSOR_OPS_PER_S = 1979e12  # dense int8 tensor-core rate (data sheet)
FP32_OPS_PER_S = 67e12  # float32 outside the tensor cores (data sheet)
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


def log(*args):
    print(*args, flush=True)


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


class KernelCheck:
    """Phase 3: every comparison of a kernel with its plain version."""

    NAMES = ("fxp_layer", "fxp_mlp_model", "fxp_qmatmul", "fxp_svm_model",
             "tree_ensemble")

    def __init__(self, torch, K):
        self.torch, self.K = torch, K
        self.cases = {n: 0 for n in self.NAMES}
        self.max_abs_err = {n: 0 for n in self.NAMES}
        self.wrapped = 0  # SVM cases whose x . sv^T wrapped int32

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

    def _cuda(self, *arrays):
        return [self.torch.from_numpy(a).cuda() for a in arrays]

    def layer_case(self, rng, bits, m, k, n, act, shift, frac, regime):
        K = self.K
        fmt = K.fxp.FxpFormat(bits, frac)
        a, b, bias = self._cuda(
            _ints(rng, (m, k), bits, regime), _ints(rng, (k, n), bits, regime),
            _ints(rng, (n,), bits, "full" if regime == "mid" else regime))
        got = K.layer.fxp_layer_cuda(a, b, bias, fmt, act, shift)
        want = K.layer.fxp_layer_plain(a, b, bias, fmt, act, shift)
        self._compare("fxp_layer", got, want,
                      f"w{bits} {m}x{k}x{n} {act} shift {shift} {regime}")

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

    def qmatmul_case(self, rng, bits, m, k, n, regime):
        K = self.K
        frac = {"mid": bits - 6, "full": bits - 2, "edge": bits - 1}[regime]
        fmt = K.fxp.FxpFormat(bits, frac)
        a, b = self._cuda(_ints(rng, (m, k), bits, regime),
                          _ints(rng, (k, n), bits, regime))
        got = K.qm.fxp_qmatmul_cuda(a, b, fmt)
        want = K.qm.fxp_qmatmul_plain(a, b, fmt)
        self._compare("fxp_qmatmul", got, want,
                      f"w{bits} {m}x{k}x{n} m={frac} {regime}")

    def svm_case(self, rng, bits, m, f, s, c, kind, regime):
        K, torch = self.K, self.torch
        frac = bits - 6 if regime == "mid" else bits - 1 - rng.randint(0, 4)
        fmt = K.fxp.FxpFormat(bits, frac)
        out_fmt = K.fxp.FxpFormat(bits, rng.randint(0, bits))
        x, sv, dual, icept = self._cuda(
            _ints(rng, (m, f), bits, regime), _ints(rng, (s, f), bits, regime),
            _ints(rng, (s, c), bits, "mid"), _ints(rng, (c,), bits, "full"))
        if regime == "mid":  # kernel values inside the format, not saturated
            qgamma = int(rng.randint(1, 2 ** max(1, frac // 2)))
            qcoef0 = int(rng.randint(-(2 ** frac), 2 ** frac))
        else:
            qgamma = int(rng.randint(1, 2 ** (bits - 1)))
            qcoef0 = int(rng.randint(-(2 ** (bits - 1)), 2 ** (bits - 1)))
        degree, dec_shift = 1 + rng.randint(0, 3), rng.randint(0, min(bits, 31))
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
            # the SVM per-layer route's first stage, D6 and D5 widths
            for k in (561, 8):
                for regime in regimes:
                    self.qmatmul_case(rng, bits, 7, k, N_PROTOTYPES, regime)
                for m in BATCHES:
                    self.qmatmul_case(rng, bits, m, k, N_PROTOTYPES, "mid")
            # the SVM megakernel at the D6 and D5 shapes
            for f, c in ((561, 6), (8, 10)):
                for kind in ("poly", "rbf"):
                    for regime in regimes:
                        self.svm_case(rng, bits, 7, f, N_PROTOTYPES, c, kind,
                                      regime)
                    for m in BATCHES:
                        self.svm_case(rng, bits, m, f, N_PROTOTYPES, c, kind,
                                      "mid")
        if not self.wrapped:
            raise AssertionError("no SVM case wrapped the int32 dot")
        # the tree on float rows with non-finite values, and quantized rows
        torch, fxp = self.torch, self.K.fxp
        rows = np.resize(x_rows, (max(BATCHES), x_rows.shape[1]))
        flt = torch.from_numpy(non_finite_rows(rows, tree)).cuda()
        finite = torch.from_numpy(rows).cuda()
        for m in BATCHES:
            self.tree_case(tree, flt[:m], f"flt batch {m}")
        for fmt in (fxp.FXP16, fxp.FXP32):
            qt = tree.quantized(fmt)
            qx = fxp.quantize(finite, fmt).to(torch.float32)
            for m in BATCHES:
                self.tree_case(qt, qx[:m], f"{fmt} batch {m}")
        log(f"phase 3: {self.cases} kernel-vs-plain cases bit-exact "
            f"(max abs err {self.max_abs_err}; {self.wrapped} SVM cases "
            f"wrapped the int32 dot)")


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
        qx = K.fxp.quantize(xt, spec["in_fmt"]).to(torch.float32)
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
    # flt: float32 matmuls (TF32 off), labels against float64 numpy
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
             source, replaces):
        iters = 200 if m <= 3089 else 20
        ms, host_ms = cuda_ms(self.torch, kern, iters)
        plain_ms, _ = cuda_ms(self.torch, plain, max(3, iters // 20))
        bound_ms, bound_by = self.dev.bound(nbytes, ops, peak)
        log(f"  {name:14s} {tag:10s} {m:6d} {ms:9.4f} {host_ms:9.4f} "
            f"{plain_ms:9.4f} {bound_ms:9.5f} {bound_by}")
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
                "shape": f"{tag} D6 test split, batch {m}"}


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
                    T.time("fxp_mlp_model", tag, m, kern, plain,
                           _nbytes(qx, *ws, *bs, out), 2 * macs,
                           T.dev.int_peak(bits), record, "fxp_mlp_model.cu",
                           K.model.REPLACES)
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
                           K.layer.REPLACES)


def path_steps(torch, tree, x):
    """Node compares the rows ``x`` (on the card) need: the depth of the
    leaf each row reaches."""
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
        node_bytes = 20 * tree.n_nodes  # five 4-byte node arrays
        for m in TIMED_BATCHES:
            x = torch.from_numpy(x_big[:m]).cuda()
            if spec is not None:
                x = K.fxp.quantize(x, spec["in_fmt"]).to(torch.float32)
            kern = lambda: K.te.tree_ensemble_cuda(tree, x)
            plain = lambda: K.te.tree_ensemble_plain(tree, x)
            out = kern()
            # the scan reads whole rows (F finiteness tests each), then
            # one compare per node on each row's path
            ops = m * x.shape[1] + path_steps(torch, tree, x)
            T.time("tree_ensemble", tag, m, kern, plain,
                   _nbytes(x, out) + node_bytes, ops, FP32_OPS_PER_S,
                   tag == "fxp16" and m == n_test, "tree_ensemble.cu",
                   K.te.REPLACES)
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
                       "fxp_svm_model.cu", K.model.SVM_REPLACES)
                if kind != "svm-rbf":
                    continue
                kern = lambda: K.qm.fxp_qmatmul_cuda(qx, svt, fmt)
                plain = lambda: K.qm.fxp_qmatmul_plain(qx, svt, fmt)
                out = kern()
                T.time("fxp_qmatmul", tag, m, kern, plain,
                       _nbytes(qx, svt, out), 2 * m * f * s,
                       T.dev.int_peak(bits), tag == "fxp16" and m == n_test,
                       "fxp_qmatmul.cu", K.qm.REPLACES)


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


def predict_breakdown(torch, K, art, x_big, batches):
    """Where one megakernel predict spends its time: each stage of
    ``predict`` run alone between synchronizations, host clock, median."""
    spec = art.extras["emit_spec"]
    ws = [torch.from_numpy(w).cuda() for w in spec["ws"]]
    bs = [torch.from_numpy(b).cuda() for b in spec["bs"]]
    sched = tuple(zip(spec["shifts"], spec["out_fmts"], spec["acts"]))
    for m in batches:
        xb = np.ascontiguousarray(x_big[:m])
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
        log(f"  predict stages, mlp fxp16, batch {m} (ms): {parts}")


def timing(torch, K, dev, d6, check, arts_a, arts_b, tree_model, launches):
    x_big = np.resize(d6.x_test, (max(TIMED_BATCHES), d6.x_test.shape[1]))
    n_test = len(d6.x_test)
    T = Timer(torch, dev, check, launches)
    time_mlp(torch, K, T, arts_a, x_big, n_test)
    time_tree_svm(torch, K, T, arts_b, tree_model, x_big, n_test)
    predict_breakdown(torch, K, arts_a[("mlp", "fxp16")], x_big,
                      (n_test, max(TIMED_BATCHES)))
    log("  predict end to end (host clock around predict -> numpy labels)")
    for tag in TAGS:
        for kind in ("mlp", "logistic"):
            time_predict(arts_a[(kind, tag)], x_big, f"{kind} {tag}")
    for key in (("tree", "D6", "fxp16"), ("tree", "D6", "flt"),
                ("svm-rbf", "D6", "fxp16"), ("svm-poly", "D6", "fxp16")):
        time_predict(arts_b[key], x_big, " ".join(key[::2]))
    return [T.records[n] for n in KernelCheck.NAMES]


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
    from repro_torch.kernels import (build, fxp_layer, fxp_model, fxp_qmatmul,
                                     tree_ensemble)
    from repro_torch.models.svm import _pick_prototypes

    K = types.SimpleNamespace(
        tc=tc, models=models, common=common, fxp=fxp, trees=trees,
        layer=fxp_layer, model=fxp_model, qm=fxp_qmatmul, te=tree_ensemble,
        pick_prototypes=_pick_prototypes,
        launchers={"fxp_layer": fxp_layer.fxp_layer_cuda,
                   "fxp_mlp_model": fxp_model.fxp_mlp_model_cuda,
                   "fxp_qmatmul": fxp_qmatmul.fxp_qmatmul_cuda,
                   "fxp_svm_model": fxp_model.fxp_svm_model_cuda,
                   "tree_ensemble": tree_ensemble.tree_ensemble_cuda})

    t_start = time.perf_counter()
    # float targets: full float32 matmuls, as the reference computes them
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = Device(torch)

    t0 = time.perf_counter()
    built = build.build_all()
    log(f"phase 2: built {list(built)} in {time.perf_counter() - t0:.1f} s "
        f"(per library: { {k: round(v, 1) for k, v in built.items()} })")
    for name, out in build.BUILD_LOG.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"  ptxas {name}: {line.strip()}")
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
    launches = {n: (launches_a[n] + launches_b[n],
                    {"A": launches_a[n], "B": launches_b[n]})
                for n in KernelCheck.NAMES}
    kernels = timing(torch, K, dev, d6, check, arts_a, arts_b, tree_model,
                     launches)
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(dev.smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev.name, "count": dev.count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
