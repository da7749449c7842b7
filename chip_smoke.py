#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (the port's quickest proof
that it still starts, builds and computes the right bits on the card).

    python3 chip_smoke.py

Phases, each of which raises on failure:

1. Device: the card's name, count and ``nvidia-smi`` name/power limit.
   Exits non-zero without a CUDA device.
2. Build every CUDA kernel of the main path from ``src/repro_torch/kernels/
   csrc`` (one ``nvcc`` per source, in parallel) and print the build time
   and ``ptxas`` resource lines.
3. Each kernel against its plain PyTorch version on the card, bit for bit,
   at the main path's shapes (561x64, 64x6 and 561x6 layers; the 561->64->6
   MLP), every container width and activation, shifts 0 and width-1,
   values at qmin/qmax, int32-wrapping sums, batches 1..65536.
4. The main path: D6 ("har") from its seed, a seeded 561->64->6 MLP and a
   561x6 logistic model, compiled for ``backend="cuda"`` at fxp32, fxp16,
   fxp16_pwl4, auto16 and auto8 (auto* calibrated on 256 train rows), then
   ``predict`` on the 3089-row test split and the batch ladder 1..64.  Every
   MLP predict is one megakernel launch, every logistic predict one
   fxp_layer launch; labels equal the plain versions' on the card; the
   forced per-layer route (``REPRO_MEGAKERNEL_VMEM=0``) gives the same
   labels with two fxp_layer launches; ``flt`` runs too.
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

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
INT8_TENSOR_OPS_PER_S = 1979e12  # dense int8 tensor-core rate (data sheet)
INT32_LANES_PER_SM = 64  # Hopper SM: 64 INT32 lanes, one IMAD (2 ops) each
TAGS = {
    "fxp32": dict(number_format="fxp32"),
    "fxp16": dict(number_format="fxp16"),
    "fxp16_pwl4": dict(number_format="fxp16", sigmoid="pwl4"),
    "auto16": dict(number_format="auto16"),
    "auto8": dict(number_format="auto8"),
}
BATCHES = (1, 7, 64, 3089, 65536)
TIMED_BATCHES = (1, 64, 3089, 65536)


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
            f"{INT8_TENSOR_OPS_PER_S / 1e12:.0f} Top/s")

    def bound(self, nbytes: int, ops: int, bits: int):
        """(bound_ms, bound_by): the larger of bytes over the memory rate and
        operations over the peak rate for the operand type."""
        peak = INT8_TENSOR_OPS_PER_S if bits == 8 else self.int32_ops_per_s
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / peak
        return (max(t_bytes, t_ops) * 1e3,
                "bytes" if t_bytes >= t_ops else "operations")


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


class KernelCheck:
    """Phase 3: every comparison of a kernel with its plain version."""

    def __init__(self, torch, fxp, layer, model):
        self.torch, self.fxp, self.layer, self.model = torch, fxp, layer, model
        self.cases = {"fxp_layer": 0, "fxp_mlp_model": 0}
        self.max_abs_err = {"fxp_layer": 0, "fxp_mlp_model": 0}

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

    def layer_case(self, rng, bits, m, k, n, act, shift, frac, regime):
        torch = self.torch
        fmt = self.fxp.FxpFormat(bits, frac)
        a, b = _ints(rng, (m, k), bits, regime), _ints(rng, (k, n), bits, regime)
        bias = _ints(rng, (n,), bits, "full" if regime == "mid" else regime)
        a, b, bias = (torch.from_numpy(v).cuda() for v in (a, b, bias))
        got = self.layer.fxp_layer_cuda(a, b, bias, fmt, act, shift)
        want = self.layer.fxp_layer_plain(a, b, bias, fmt, act, shift)
        self._compare("fxp_layer", got, want,
                      f"w{bits} {m}x{k}x{n} {act} shift {shift} {regime}")

    def model_case(self, rng, bits, m, dims, act, shifts, fracs, regime):
        torch = self.torch
        sched = tuple((s, self.fxp.FxpFormat(bits, f), a) for s, f, a in
                      zip(shifts, fracs, [act] * (len(dims) - 2) + ["none"]))
        x = torch.from_numpy(_ints(rng, (m, dims[0]), bits, regime)).cuda()
        ws = [torch.from_numpy(_ints(rng, (i, o), bits, regime)).cuda()
              for i, o in zip(dims, dims[1:])]
        bs = [torch.from_numpy(_ints(rng, (o,), bits, "full")).cuda()
              for o in dims[1:]]
        got = self.model.fxp_mlp_model_cuda(x, ws, bs, sched)
        want = self.model.fxp_mlp_model_plain(x, ws, bs, sched)
        self._compare("fxp_mlp_model", got, want,
                      f"w{bits} {m}x{dims} {act} shifts {shifts} {regime}")

    def run(self):
        rng = np.random.RandomState(0)
        acts = self.layer.LAYER_ACTIVATIONS
        shapes = ((561, 64), (64, 6), (561, 6))
        i = 0
        for bits in (8, 16, 32):
            regimes = ("mid", "full", "edge")
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
        log(f"phase 3: {self.cases} kernel-vs-plain cases bit-exact "
            f"(max abs err {self.max_abs_err})")


# --------------------------------------------------------------------------
# phase 4: the main path
# --------------------------------------------------------------------------
def _plain_labels(torch, fxp, layer, model, common, art, x):
    """The artifact's frozen program run through the plain versions on the
    card: quantize with the artifact's input format, then the plain kernel."""
    spec = art.extras["emit_spec"]
    qx = fxp.quantize(torch.from_numpy(x).cuda(), spec["in_fmt"])
    if spec["family"] == "mlp":
        sched = tuple(zip(spec["shifts"], spec["out_fmts"], spec["acts"]))
        out = model.fxp_mlp_model_plain(
            qx, [torch.from_numpy(w).cuda() for w in spec["ws"]],
            [torch.from_numpy(b).cuda() for b in spec["bs"]], sched)
    else:
        out = layer.fxp_layer_plain(qx, torch.from_numpy(spec["w"]).cuda(),
                                    torch.from_numpy(spec["b"]).cuda(),
                                    spec["out_fmt"], "none", spec["shift"])
    return common.argmax_first(out).cpu().numpy()


def _launches(layer, model):
    return layer.fxp_layer_cuda.launches, model.fxp_mlp_model_cuda.launches


def _expect_launches(layer, model, before, want, what):
    got = tuple(a - b for a, b in zip(_launches(layer, model), before))
    if got != want:
        raise AssertionError(f"{what}: (fxp_layer, fxp_mlp_model) launches "
                             f"{got}, expected {want}")


def main_path(torch, mods, ds):
    fxp, layer, model, common, tc, models = mods
    x_test, x_cal = ds.x_test, ds.x_train[:256]
    mlp = models.init_mlp([561, 64, 6], seed=0)
    rng = np.random.RandomState(0)
    logistic = models.LogisticModel(
        coef=(rng.randn(561, 6) * np.sqrt(2.0 / (561 + 6))).astype(np.float32),
        intercept=np.zeros(6, np.float32))
    ladder = [x_test[:b] for b in (1, 2, 4, 8, 16, 32, 64)]
    arts, mlp_labels = {}, {}
    # Every count starts at 0 just before the main path and is read after it.
    layer.fxp_layer_cuda.launches = 0
    model.fxp_mlp_model_cuda.launches = 0
    t0 = time.perf_counter()
    for tag, kw in TAGS.items():
        cal = x_cal if kw["number_format"].startswith("auto") else None
        for kind, m in (("mlp", mlp), ("logistic", logistic)):
            art = tc.compile(m, tc.Target(backend="cuda", **kw),
                             calibration=cal)
            arts[(kind, tag)] = art
            if kind == "mlp" and art.kernel_strategy != "megakernel":
                raise AssertionError(f"D6 mlp {tag} routed "
                                     f"{art.kernel_strategy}, not megakernel")
            one = (0, 1) if kind == "mlp" else (1, 0)
            before = _launches(layer, model)
            labels = art.predict(x_test)
            _expect_launches(layer, model, before, one, f"{kind} {tag} predict")
            if labels.shape != (len(x_test),) or labels.dtype != np.int32:
                raise AssertionError(f"{kind} {tag}: labels {labels.dtype}"
                                     f"{labels.shape}")
            if labels.min() < 0 or labels.max() >= ds.n_classes:
                raise AssertionError(f"{kind} {tag}: label out of range")
            for xb in ladder:
                before = _launches(layer, model)
                lab = art.predict(xb)
                _expect_launches(layer, model, before, one,
                                 f"{kind} {tag} batch {len(xb)}")
                if not np.array_equal(lab, labels[:len(xb)]):
                    raise AssertionError(f"{kind} {tag}: batch {len(xb)} "
                                         f"labels differ from the full batch")
            plain = _plain_labels(torch, fxp, layer, model, common, art, x_test)
            if not np.array_equal(labels, plain):
                raise AssertionError(f"{kind} {tag}: {int((labels != plain).sum())}"
                                     f" labels differ from the plain versions")
            if kind == "mlp":
                mlp_labels[tag] = labels
            ref = tc.compile(m, tc.Target(backend="ref", **kw), calibration=cal)
            diff = int((ref.predict(x_test) != labels).sum())
            log(f"  {kind:8s} {tag:10s} labels {np.bincount(labels, minlength=6)}"
                f" == plain; rows differing ref vs cuda (int64 vs int32 "
                f"accumulator, information): {diff}")
        # the forced per-layer route: same labels, two fxp_layer launches
        os.environ["REPRO_MEGAKERNEL_VMEM"] = "0"
        try:
            per = tc.compile(mlp, tc.Target(backend="cuda", **kw),
                             calibration=cal)
        finally:
            del os.environ["REPRO_MEGAKERNEL_VMEM"]
        if per.kernel_strategy != "per-layer":
            raise AssertionError(f"forced route {per.kernel_strategy}")
        before = _launches(layer, model)
        if not np.array_equal(per.predict(x_test), mlp_labels[tag]):
            raise AssertionError(f"mlp {tag}: per-layer labels differ")
        _expect_launches(layer, model, before, (2, 0), f"mlp {tag} per-layer")
    # flt: float32 matmuls (TF32 off), labels against float64 numpy
    for kind, m in (("mlp", mlp), ("logistic", logistic)):
        art = tc.compile(m, tc.Target(number_format="flt", backend="cuda"))
        labels = art.predict(x_test)
        logits = _float64_logits(m, x_test)
        top2 = np.sort(logits, axis=1)[:, -2:]
        decided = (top2[:, 1] - top2[:, 0]) >= 1e-4
        if not np.array_equal(labels[decided], logits.argmax(1)[decided]):
            raise AssertionError(f"flt {kind}: labels differ from float64")
        log(f"  {kind:8s} flt        labels match float64 on "
            f"{int(decided.sum())}/{len(x_test)} rows with top-2 gap >= 1e-4")
    launches = {"fxp_layer": layer.fxp_layer_cuda.launches,
                "fxp_mlp_model": model.fxp_mlp_model_cuda.launches}
    log(f"phase 4: main path in {time.perf_counter() - t0:.1f} s; kernel "
        f"launches {launches}")
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"the main path never launched {name}")
    return arts, launches


def _float64_logits(m, x):
    h = np.asarray(x, np.float64)
    if not hasattr(m, "weights"):  # logistic
        return h @ m.coef + m.intercept
    for i, (w, b) in enumerate(zip(m.weights, m.biases)):
        h = h @ w + b
        if i < len(m.weights) - 1:
            h = 1.0 / (1.0 + np.exp(-h))
    return h


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


def timing(torch, mods, dev, ds, arts, check, launches):
    fxp, layer, model, common, tc, _ = mods
    x_big = np.resize(ds.x_test, (max(TIMED_BATCHES), ds.x_test.shape[1]))
    records = {}
    log("phase 5: kernel times (CUDA events, warm L2, mean over iterations)")
    log(f"  {'kernel':14s} {'tag':7s} {'batch':>6s} {'ms':>9s} {'host_ms':>9s}"
        f" {'plain_ms':>9s} {'bound_ms':>9s} bound_by")
    for tag in ("fxp16", "auto8", "fxp32"):
        for kind in ("mlp", "logistic"):
            spec = arts[(kind, tag)].extras["emit_spec"]
            bits = spec["in_fmt"].total_bits
            for m in TIMED_BATCHES:
                qx = fxp.quantize(torch.from_numpy(x_big[:m]).cuda(),
                                  spec["in_fmt"])
                if kind == "mlp":
                    name = "fxp_mlp_model"
                    ws = [torch.from_numpy(w).cuda() for w in spec["ws"]]
                    bs = [torch.from_numpy(b).cuda() for b in spec["bs"]]
                    sched = tuple(zip(spec["shifts"], spec["out_fmts"],
                                      spec["acts"]))
                    kern = lambda: model.fxp_mlp_model_cuda(qx, ws, bs, sched)
                    plain = lambda: model.fxp_mlp_model_plain(qx, ws, bs, sched)
                    tensors = [qx, *ws, *bs]
                    macs = m * sum(w.shape[0] * w.shape[1] for w in ws)
                else:
                    name = "fxp_layer"
                    w = torch.from_numpy(spec["w"]).cuda()
                    b = torch.from_numpy(spec["b"]).cuda()
                    fmt, sh = spec["out_fmt"], spec["shift"]
                    kern = lambda: layer.fxp_layer_cuda(qx, w, b, fmt, "none", sh)
                    plain = lambda: layer.fxp_layer_plain(qx, w, b, fmt, "none",
                                                          sh)
                    tensors = [qx, w, b]
                    macs = m * w.shape[0] * w.shape[1]
                out = kern()
                nbytes = sum(t.numel() * t.element_size() for t in tensors) \
                    + out.numel() * out.element_size()
                iters = 200 if m <= 3089 else 20
                ms, host_ms = cuda_ms(torch, kern, iters)
                plain_ms, _ = cuda_ms(torch, plain, max(3, iters // 20))
                bound_ms, bound_by = dev.bound(nbytes, 2 * macs, bits)
                log(f"  {name:14s} {tag:7s} {m:6d} {ms:9.4f} {host_ms:9.4f} "
                    f"{plain_ms:9.4f} {bound_ms:9.5f} {bound_by}")
                if tag == "fxp16" and m == len(ds.x_test):
                    src = "fxp_layer.cu" if name == "fxp_layer" else \
                        "fxp_mlp_model.cu"
                    mod = layer if name == "fxp_layer" else model
                    records[name] = {
                        "name": name, "route": "cuda",
                        "source": f"src/repro_torch/kernels/csrc/{src}",
                        "replaces": mod.REPLACES,
                        "launches": launches[name],
                        "max_abs_err": check.max_abs_err[name],
                        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                        "bound_by": bound_by, "library_ms": None,
                        "shape": f"fxp16 D6 test split, batch {m}"}
    predict_breakdown(torch, mods, arts[("mlp", "fxp16")], x_big,
                      (len(ds.x_test), max(TIMED_BATCHES)))
    log("  predict end to end (host clock around predict -> numpy labels)")
    for tag in TAGS:
        for kind in ("mlp", "logistic"):
            art = arts[(kind, tag)]
            for m in (len(ds.x_test), max(TIMED_BATCHES)):
                xb = x_big[:m]
                art.predict(xb)
                times = []
                for _ in range(10):
                    t0 = time.perf_counter()
                    art.predict(xb)
                    times.append(time.perf_counter() - t0)
                ms = float(np.median(times)) * 1e3
                log(f"  predict {kind:8s} {tag:10s} batch {m:6d}: "
                    f"{ms:8.3f} ms, {m / ms * 1e3:12.0f} rows/s")
    return [records["fxp_layer"], records["fxp_mlp_model"]]


def predict_breakdown(torch, mods, art, x_big, batches):
    """Where one megakernel predict spends its time: each stage of
    ``predict`` run alone between synchronizations, host clock, median."""
    fxp, _, model, common, _, _ = mods
    spec = art.extras["emit_spec"]
    ws = [torch.from_numpy(w).cuda() for w in spec["ws"]]
    bs = [torch.from_numpy(b).cuda() for b in spec["bs"]]
    sched = tuple(zip(spec["shifts"], spec["out_fmts"], spec["acts"]))
    for m in batches:
        xb = np.ascontiguousarray(x_big[:m])
        state = {}
        stages = (
            ("copy rows to card", lambda: state.update(
                x=common.as_input(xb, art.device))),
            ("quantize + stats", lambda: state.update(
                q=fxp.quantize_with_stats(state["x"], spec["in_fmt"])[0])),
            ("fxp_mlp_model kernel", lambda: state.update(
                out=model.fxp_mlp_model_cuda(state["q"], ws, bs, sched))),
            ("argmax", lambda: state.update(
                lab=common.argmax_first(state["out"]))),
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke runs on a GPU host",
              file=sys.stderr)
        return 2
    from repro_torch.compile.lowerings import common
    from repro_torch import compile as tc
    from repro_torch import models
    from repro_torch.core import fixedpoint as fxp
    from repro_torch.data import load_dataset
    from repro_torch.kernels import build, fxp_layer, fxp_model

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
    check = KernelCheck(torch, fxp, fxp_layer, fxp_model)
    check.run()
    log(f"  phase 3 took {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    ds = load_dataset("D6")
    log(f"D6 generated in {time.perf_counter() - t0:.1f} s: train "
        f"{ds.x_train.shape}, test {ds.x_test.shape}")
    mods = (fxp, fxp_layer, fxp_model, common, tc, models)
    arts, launches = main_path(torch, mods, ds)
    kernels = timing(torch, mods, dev, ds, arts, check, launches)
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(dev.smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev.name, "count": dev.count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
