"""Roofline terms of a step: the counterpart of :mod:`repro.roofline.analysis`.

Hardware model: one NVIDIA H100 80GB HBM3 (SXM) at its 700 W limit, the
data sheet's dense rates (:class:`HW`).  No TPU figure carries over.

Terms (per device):
  compute term    = FLOPs_dev / peak
  memory term     = bytes_dev / HBM_bw
  collective term = collective_bytes_dev / link_bw   (one link direction)

The port's dry run (:mod:`repro_torch.launch.dryrun`) compiles nothing, so
its terms come from the analytic model (:mod:`.analytic`).
:func:`collective_bytes_from_hlo` is the reference's parser of optimized
HLO text, kept verbatim: it reads text only (it sums the *result* shapes of
every all-gather / all-reduce / reduce-scatter / all-to-all /
collective-permute op; shapes in a partitioned module are per-device), so
it serves the reference's records and its tests.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, Optional

__all__ = ["HW", "collective_bytes_from_hlo", "roofline_terms", "model_flops",
           "RooflineReport"]


@dataclasses.dataclass(frozen=True)
class HW:
    """One NVIDIA H100 80GB HBM3 (SXM) at 700 W: NVIDIA's H100 data sheet,
    dense rates without sparsity."""

    # bf16 tensor-core rate, dense (data sheet: 989 TFLOP/s), H100 SXM 700 W
    peak_flops: float = 989.4e12
    # HBM3 bandwidth (data sheet: 3.35 TB/s), H100 SXM 700 W
    hbm_bw: float = 3.35e12
    # NVLink 4: 900 GB/s per GPU both ways, 450e9 B/s per direction
    # (data sheet), H100 SXM 700 W
    ici_bw: float = 450e9
    # HBM3 capacity (data sheet: 80 GB), H100 SXM 700 W
    hbm_bytes: float = 80e9


_DTYPE_BYTES = {
    "pred": 1, "s2": 1, "s4": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2,
    "s32": 4, "u32": 4, "s64": 8, "u64": 8,
    "f8e4m3fn": 1, "f8e5m2": 1, "bf16": 2, "f16": 2, "f32": 4, "f64": 8,
    "c64": 8, "c128": 16,
}

_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "collective-permute")

# matches e.g. bf16[2,4096,512] or f32[128]{0} or s8[16,16]
_SHAPE_RE = re.compile(r"\b([a-z]+[0-9]+(?:e[0-9]+m[0-9]+(?:fn)?)?|pred)\[([0-9,]*)\]")


def _shape_bytes(dtype: str, dims: str) -> int:
    if dtype not in _DTYPE_BYTES:
        return 0
    n = 1
    if dims:
        for d in dims.split(","):
            n *= int(d)
    return n * _DTYPE_BYTES[dtype]


def collective_bytes_from_hlo(hlo_text: str) -> Dict[str, int]:
    """Sum result-shape bytes per collective kind over the module text."""
    out = {k: 0 for k in _COLLECTIVES}
    out["total"] = 0
    for line in hlo_text.splitlines():
        stripped = line.strip()
        # instruction lines look like: "%name = TYPE[SHAPE] op-name(...)"
        m = re.search(r"=\s*(.+?)\s+([a-z0-9-]+)\(", stripped)
        if not m:
            continue
        opname = m.group(2)
        kind = None
        for c in _COLLECTIVES:
            if opname == c or opname.startswith(c + "-start") or \
                    opname.startswith(c + "."):
                kind = c
                break
        if kind is None:
            continue
        lhs = m.group(1)
        nbytes = sum(_shape_bytes(dt, dims) for dt, dims in _SHAPE_RE.findall(lhs))
        out[kind] += nbytes
        out["total"] += nbytes
    return out


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_dev: float
    bytes_dev: float
    coll_bytes_dev: float
    t_compute: float
    t_memory: float
    t_collective: float
    dominant: str
    model_flops_global: float
    useful_ratio: float  # MODEL_FLOPS / global HLO flops
    bytes_per_device: Optional[float] = None  # argument bytes a device
    note: str = ""

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)


def roofline_terms(*, arch: str, shape: str, mesh_name: str, chips: int,
                   flops_dev: float, bytes_dev: float, coll_bytes_dev: float,
                   model_flops_global: float, hw: HW = HW(),
                   bytes_per_device: Optional[float] = None,
                   note: str = "") -> RooflineReport:
    t_c = flops_dev / hw.peak_flops
    t_m = bytes_dev / hw.hbm_bw
    t_x = coll_bytes_dev / hw.ici_bw
    dom = max((("compute", t_c), ("memory", t_m), ("collective", t_x)),
              key=lambda kv: kv[1])[0]
    hlo_global = flops_dev * chips
    ratio = model_flops_global / hlo_global if hlo_global else 0.0
    return RooflineReport(arch, shape, mesh_name, chips, flops_dev, bytes_dev,
                          coll_bytes_dev, t_c, t_m, t_x, dom,
                          model_flops_global, ratio, bytes_per_device, note)


def model_flops(param_count_active: int, tokens: int, kind: str) -> float:
    """MODEL_FLOPS: 6·N·D train (fwd+bwd), 2·N·D forward-only."""
    mult = 6 if kind == "train" else 2
    return float(mult) * param_count_active * tokens
