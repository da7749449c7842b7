"""Weight-only Qn.m quantization for LM serving (paper C1).

The PyTorch counterpart of :mod:`repro.core.quantize`.  Decode is bound by
the bytes of the weights it reads, so int8/int16 weights with a dequant at
use cut the dominant term 2-4x.  Two scale modes:

* ``qnm`` (paper-faithful): one global power-of-two scale per tensor — for
  a stacked (L, din, dout) tensor, one exponent from the max over all L;
* ``per_channel``: one float scale per output channel (the max over the
  contraction axis, -2).

Quantized linears become ``{"w_q": intN, "scale": float32}``, equal bit for
bit to the reference's (``torch.round`` rounds half to even, as
``jnp.round`` does).  Every call site goes through
:func:`repro_torch.lm.layers.apply_linear`, which converts at use.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

__all__ = ["QuantSpec", "quantize_linear", "quantize_lm_params",
           "quantized_param_bytes"]

_INT_DTYPES = {8: torch.int8, 16: torch.int16}


@dataclasses.dataclass(frozen=True)
class QuantSpec:
    bits: int = 8  # container width (8 or 16)
    mode: str = "per_channel"  # 'per_channel' | 'qnm'
    min_size: int = 1 << 16  # only quantize tensors at least this large
    keep_embed: bool = False  # quantize embedding/unembedding tables too

    @property
    def dtype(self) -> torch.dtype:
        return _INT_DTYPES[self.bits]

    @property
    def qmax(self) -> int:
        return (1 << (self.bits - 1)) - 1


def quantize_linear(w: torch.Tensor, spec: QuantSpec) -> Dict[str, torch.Tensor]:
    """(..., din, dout) float -> {'w_q': intN, 'scale': float32}.

    ``scale`` keeps a singleton contraction dim — shape (..., 1, dout) — so
    ``w_q * scale`` broadcasts for 2-D linears and stacked (L, d, f) tensors
    alike.
    """
    w32 = w.to(torch.float32)
    if spec.mode == "per_channel":
        amax = torch.amax(torch.abs(w32), dim=-2, keepdim=True)
        scale = torch.clamp_min(amax, 1e-8) / spec.qmax
    elif spec.mode == "qnm":
        # one shared exponent for the whole (stacked) tensor
        amax = torch.amax(torch.abs(w32))
        exp = torch.ceil(torch.log2(torch.clamp_min(amax, 1e-8) / spec.qmax))
        scale = torch.pow(2.0, exp).expand(
            tuple(w32.shape[:-2]) + (1, w32.shape[-1]))
    else:
        raise KeyError(f"unknown quant mode {spec.mode}")
    # rounded and clamped in place, w32 dropped first: a stacked expert
    # tensor (deepseek-v3's is 15 GB in float32) is held at most twice
    q = w32 / scale
    del w32
    q = q.round_().clamp_(-spec.qmax - 1, spec.qmax)
    return {"w_q": q.to(spec.dtype),
            "scale": scale.to(torch.float32).contiguous()}


def _is_linear_dict(d: Any) -> bool:
    return (isinstance(d, dict) and "w" in d
            and isinstance(d["w"], torch.Tensor) and d["w"].dim() >= 2)


def quantize_lm_params(params: Dict, spec: Optional[QuantSpec] = None,
                       _path: str = "") -> Dict:
    """Walk an LM param tree, replacing large linear dicts with quantized
    ones.  Embedding tables stay float unless ``spec.keep_embed``."""
    spec = spec or QuantSpec()
    out = {}
    for k, v in params.items():
        path = f"{_path}/{k}"
        if _is_linear_dict(v) and "router" not in path:
            skip_embed = ("embed" in path or "table" in path) and not spec.keep_embed
            if v["w"].numel() >= spec.min_size and not skip_embed:
                q = quantize_linear(v["w"], spec)
                if "b" in v:
                    q["b"] = v["b"]
                out[k] = q
                continue
        if isinstance(v, dict):
            if "table" in v:  # embed dict
                out[k] = v
            else:
                out[k] = quantize_lm_params(v, spec, path)
        else:
            out[k] = v
    return out


def _leaves(tree: Any, path: str = ""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    else:
        yield path, tree


def quantized_param_bytes(params: Dict) -> Tuple[int, int]:
    """(total_bytes, quantized_bytes) of a (possibly quantized) param tree."""
    total = q = 0
    for path, leaf in _leaves(params):
        n = leaf.numel() * leaf.element_size()
        total += n
        if path.endswith("/w_q"):
            q += n
    return total, q
