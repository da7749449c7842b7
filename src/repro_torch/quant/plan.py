"""Per-tensor Qn.m planning: observed ranges in, a frozen ``QuantPlan`` out.

The paper fixes one global Qn.m exponent for the whole model (its §IX names
this the tool's main limitation): small-range tensors waste fractional bits,
large-range tensors saturate.  A :class:`QuantPlan` removes the single-
exponent constraint while keeping everything else the paper relies on — one
integer container width, shift/add requantization, saturating arithmetic:
every tensor path (weights, biases, thresholds, support vectors, per-layer
activations) gets its *own* fractional-bit count, the largest one that
represents the observed range without saturating.

Planning constraints (enforced by :func:`plan_formats`):

* **range** — ``amax * 2^frac <= qmax`` per path, so nothing observed during
  calibration saturates;
* **groups** — paths that must share one scale (tree inputs vs thresholds,
  a bias added to an accumulator, SVM inputs vs support vectors) take the
  minimum fractional bits over their members;
* **matmul accumulators** — for each ``out = a @ b`` the integer accumulator
  ``acc * 2^(fa+fb)`` must fit the narrowest accumulator any backend uses
  (int32 in the CUDA kernels, ``fmt.wide_dtype`` on the reference path), with
  2x headroom for quantization noise — this is what keeps
  ``ref == cuda`` bit-identical for calibrated targets;
* **shift** — ``f_out <= f_a + f_b`` so the requantization shift
  (:func:`repro_torch.core.fixedpoint.requantize`) is non-negative.

The plan is frozen, hashable, and serializable: its :meth:`~QuantPlan.
descriptor` feeds ``CompiledArtifact.cache_key`` (and the serving
``ArtifactCache``), and :meth:`~QuantPlan.to_dict` rides inside artifact
archives so a loaded artifact reproduces the saved one bit-for-bit without
re-running calibration.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Mapping, Tuple

from repro_torch.core.fixedpoint import FxpFormat

__all__ = ["QuantPlan", "Calibration", "choose_frac_bits", "plan_formats"]

# Headroom multiplier on observed matmul-accumulator magnitudes: input
# quantization error perturbs the integer accumulator around its float
# estimate, so the width constraint is checked against 2x the observed peak
# (one extra bit) rather than the peak itself.
_ACC_HEADROOM = 2.0


@dataclasses.dataclass(frozen=True)
class Calibration:
    """Observed per-tensor statistics from one float pass over a sample batch.

    Produced by each lowering's ``calibrate(params, x, target)``; consumed by
    :func:`plan_formats`.

    * ``ranges`` — tensor path -> max absolute value the tensor (or any
      intermediate that lives in its format) takes;
    * ``groups`` — tuples of paths constrained to share one format;
    * ``matmuls`` — ``(a_path, b_path, out_path)`` triples for every integer
      matmul the lowering emits (drives the accumulator-width constraint);
    * ``acc_ranges`` — ``out_path`` -> max absolute value of the float
      accumulator (pre-shift, pre-bias) for that matmul.
    """

    ranges: Mapping[str, float]
    groups: Tuple[Tuple[str, ...], ...] = ()
    matmuls: Tuple[Tuple[str, str, str], ...] = ()
    acc_ranges: Mapping[str, float] = dataclasses.field(default_factory=dict)


def choose_frac_bits(amax: float, total_bits: int) -> int:
    """Maximal fractional bits representing ``[-amax, amax]`` in the container.

    The largest ``frac`` with ``amax * 2^frac <= qmax`` (so the observed peak
    quantizes inside the container, round-to-nearest included), clamped to
    ``[0, total_bits - 1]``.  An all-zero tensor gets every fractional bit.
    """
    qmax = 2 ** (total_bits - 1) - 1
    a = abs(float(amax))
    if a == 0.0:
        return total_bits - 1
    frac = total_bits - 1
    while frac > 0 and a * (1 << frac) > qmax:
        frac -= 1
    return frac


def _acc_budget(total_bits: int) -> int:
    """Largest ``log2`` magnitude a matmul accumulator may reach, across
    every backend's accumulator dtype.

    The CUDA kernels accumulate int32 regardless of container; the
    reference path accumulates in ``fmt.wide_dtype`` (int16 for the 8-bit
    container).  Bit-identity requires neither to wrap, so the budget is the
    narrower of the two: ``min(31, 2*total_bits - 1)`` magnitude bits.
    """
    return min(31, 2 * total_bits - 1)


@dataclasses.dataclass(frozen=True)
class QuantPlan:
    """Frozen per-tensor Qn.m assignment for one compiled artifact.

    ``formats`` maps tensor paths to fractional-bit counts inside the shared
    ``total_bits`` container; ``ranges`` records the calibration evidence
    (max |value| per path) for the resource report.
    """

    total_bits: int
    formats: Tuple[Tuple[str, int], ...]  # sorted (path, frac_bits)
    ranges: Tuple[Tuple[str, float], ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "_frac", dict(self.formats))
        object.__setattr__(
            self, "_fmt",
            {p: FxpFormat(self.total_bits, f) for p, f in self.formats})

    # -- lookups -------------------------------------------------------------
    def fmt(self, path: str) -> FxpFormat:
        """The planned format for ``path`` (KeyError on unknown paths — a
        lowering asking for a path the calibration never recorded is a bug)."""
        try:
            return self._fmt[path]
        except KeyError:
            raise KeyError(
                f"QuantPlan has no format for tensor path '{path}'; planned "
                f"paths: {sorted(self._frac)}")

    def frac_bits(self, path: str) -> int:
        self.fmt(path)  # uniform KeyError
        return self._frac[path]

    def shift(self, a_path: str, b_path: str, out_path: str) -> int:
        """Requantization shift for ``out = a @ b``: ``fa + fb - f_out``."""
        return (self.frac_bits(a_path) + self.frac_bits(b_path)
                - self.frac_bits(out_path))

    def paths(self) -> Tuple[str, ...]:
        return tuple(p for p, _ in self.formats)

    def saturating_paths(self) -> Tuple[str, ...]:
        """Paths whose *observed* range exceeds what their planned format can
        represent — i.e. the container width itself is insufficient (the
        planner already spent every integer bit; frac is 0 and the peak
        still does not fit).  Empty for a fully servable plan; non-empty
        plans will saturate even on their own calibration batch, which is
        the paper's §V-A accuracy-cliff regime."""
        qmax = 2 ** (self.total_bits - 1) - 1
        ranges = dict(self.ranges)
        return tuple(
            p for p, f in self.formats
            if abs(ranges.get(p, 0.0)) * (1 << f) > qmax)

    # -- identity / serialization -------------------------------------------
    def descriptor(self) -> Tuple:
        """Canonical hashable identity — the cache-key component.  Two plans
        with the same descriptor lower to bit-identical programs."""
        return ("qplan", self.total_bits, self.formats)

    def to_dict(self) -> Dict:
        return {"total_bits": self.total_bits,
                "formats": {p: f for p, f in self.formats},
                "ranges": {p: float(r) for p, r in self.ranges}}

    @classmethod
    def from_dict(cls, d: Mapping) -> "QuantPlan":
        return cls(total_bits=int(d["total_bits"]),
                   formats=tuple(sorted(
                       (str(p), int(f)) for p, f in d["formats"].items())),
                   ranges=tuple(sorted(
                       (str(p), float(r))
                       for p, r in d.get("ranges", {}).items())))

    def describe(self) -> str:
        """Human-readable per-tensor table (one line per path)."""
        lines = [f"QuantPlan: {len(self.formats)} tensors in "
                 f"{self.total_bits}-bit containers"]
        for path, frac in self.formats:
            fmt = self._fmt[path]
            amax = dict(self.ranges).get(path)
            obs = f"  |max| {amax:.6g}" if amax is not None else ""
            lines.append(f"  {path:<24} Q{fmt.int_bits}.{frac}{obs}")
        return "\n".join(lines)


def plan_formats(calib: Calibration, total_bits: int) -> QuantPlan:
    """Choose per-tensor formats from calibration evidence.

    Greedy-maximal fractional bits per path, then constraint repair to a
    fixpoint: groups share their minimum, accumulators must fit the
    narrowest backend accumulator, requantization shifts must be
    non-negative.  Fractional bits only ever decrease during repair, so the
    loop terminates.
    """
    if total_bits not in (8, 16, 32):
        raise ValueError(f"unsupported container width {total_bits}")
    frac: Dict[str, int] = {
        p: choose_frac_bits(a, total_bits) for p, a in calib.ranges.items()}

    def lower_to(paths: Iterable[str], value: int) -> bool:
        changed = False
        for p in paths:
            if frac[p] > value:
                frac[p] = max(0, value)
                changed = True
        return changed

    budget = _acc_budget(total_bits)
    for _ in range(32 * max(1, len(frac))):  # decreasing ints: converges fast
        changed = False
        for group in calib.groups:
            changed |= lower_to(group, min(frac[p] for p in group))
        for a, b, out in calib.matmuls:
            # int accumulator magnitude ~ |acc_float| * 2^(fa+fb); keep it
            # (with headroom) inside the narrowest backend accumulator.
            acc_amax = abs(float(calib.acc_ranges.get(out, 0.0)))
            while (frac[a] + frac[b] > 0
                   and acc_amax * _ACC_HEADROOM * (1 << (frac[a] + frac[b]))
                   > (1 << budget) - 1):
                victim = a if frac[a] >= frac[b] else b
                frac[victim] -= 1
                changed = True
            # the requantize shift fa + fb - f_out must be >= 0
            changed |= lower_to([out], frac[a] + frac[b])
        if not changed:
            break
    return QuantPlan(
        total_bits=total_bits,
        formats=tuple(sorted(frac.items())),
        ranges=tuple(sorted((p, float(a)) for p, a in calib.ranges.items())))
