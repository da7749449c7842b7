"""Lowering ``"lm"``: quantized LM serving as a compile target.

The counterpart of :mod:`repro.compile.lowerings.lm`, over the same
:class:`~repro_torch.compile.target.Target` fields:

* ``number_format`` — ``flt`` (native dtype) | ``fxp8``/``fxp16``
  (weight-only int8/int16, scale mode from ``weight_scale``);
* ``weight_scale``   — ``qnm`` (paper-faithful global power-of-two) |
  ``per_channel``;
* ``kv_cache``       — ``native`` | ``int8`` decode cache;
* ``sigmoid``        — the gate sigmoid/SiLU variant, threaded through
  ``ArchConfig.gate_sigmoid``.

``backend`` is ignored, as the reference's LM lowering ignores it: the
artifact runs on its device, the card's prefill attention through the
``flash_attention`` kernel.  The artifact's ``predict(tokens)`` runs one
greedy decode step from a fresh cache; ``extras`` exposes the serving
surface: ``serve_step``, ``init_cache`` and ``generate(tokens, n)``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, MLAConfig, MoEConfig, SSMConfig

from ..registry import Lowered, Lowering, register_lowering
from ..target import Target
from .common import zero_stats

__all__ = ["LMModel", "cfg_to_dict", "cfg_from_dict"]

_QUANT_MIN_SIZE = 4096  # quantize every serving-relevant linear
_LM_BITS = {"fxp8": 8, "fxp16": 16}


@dataclasses.dataclass
class LMModel:
    """An LM: config + parameter tree (tensors, the reference's layout)."""

    cfg: ArchConfig
    params: Dict[str, Any]

    compile_kind = "lm"


def cfg_to_dict(cfg: ArchConfig) -> Dict[str, Any]:
    return dataclasses.asdict(cfg)


def cfg_from_dict(d: Dict[str, Any]) -> ArchConfig:
    d = dict(d)
    if d.get("moe"):
        d["moe"] = MoEConfig(**d["moe"])
    if d.get("mla"):
        d["mla"] = MLAConfig(**d["mla"])
    if d.get("ssm"):
        d["ssm"] = SSMConfig(**d["ssm"])
    return ArchConfig(**d)


def _to(tree: Any, device: torch.device) -> Any:
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


@register_lowering("lm")
class LMLowering(Lowering):
    def extract_params(self, model: Any) -> Dict[str, Any]:
        return {"cfg": cfg_to_dict(model.cfg), "params": model.params}

    def quantize(self, params: Dict[str, Any], target: Target,
                 plan: Optional[Any] = None) -> Dict[str, Any]:
        from repro_torch.core.quantize import QuantSpec, quantize_lm_params

        cfg = cfg_from_dict(params["cfg"])
        # A non-default Target field wins; a default Target keeps what the
        # config already carries (the same asymmetry for both axes).
        gate = target.sigmoid if target.sigmoid != "exact" else cfg.gate_sigmoid
        cfg = dataclasses.replace(
            cfg,
            gate_sigmoid=gate,
            kv_cache_dtype="int8" if target.kv_cache == "int8" else cfg.kv_cache_dtype,
        )
        p = params["params"]
        if target.number_format != "flt":
            if target.number_format not in _LM_BITS:
                raise ValueError(
                    "lm lowering supports number_format flt/fxp8/fxp16 "
                    f"(weight-only), got '{target.number_format}'"
                    + (" — calibrated (auto*) formats are classifier-only"
                       if target.is_calibrated else ""))
            spec = QuantSpec(bits=_LM_BITS[target.number_format],
                             mode=target.weight_scale,
                             min_size=_QUANT_MIN_SIZE)
            with torch.inference_mode():
                p = quantize_lm_params(p, spec)
        return {"cfg": cfg, "params": p}

    def lower(self, qparams: Dict[str, Any], target: Target,
              plan: Optional[Any], device: torch.device) -> Lowered:
        from repro_torch.core.quantize import quantized_param_bytes
        from repro_torch.lm import model as M

        cfg: ArchConfig = qparams["cfg"]
        if cfg.encoder_only:
            raise ValueError(f"{cfg.name} is encoder-only: no decode serving")
        params = _to(qparams["params"], device)

        def step(p, cache, batch):
            return M.serve_step(p, cache, batch, cfg)

        def init_cache(batch: int, max_len: int):
            return M.init_cache(cfg, batch, max_len, device)

        def _tokens(tokens) -> torch.Tensor:
            if not isinstance(tokens, torch.Tensor):
                tokens = torch.from_numpy(np.asarray(tokens))
            return tokens.to(device=device, dtype=torch.int32)

        @torch.inference_mode()
        def generate(tokens: np.ndarray, n_tokens: int,
                     cache: Optional[Dict] = None) -> np.ndarray:
            """Greedy-decode ``n_tokens`` continuations.  tokens: (B,) int."""
            tok = _tokens(tokens)
            if cache is None:
                cache = init_cache(tok.shape[0], n_tokens + 4)
            out = [tok]
            for _ in range(n_tokens):
                logits, cache = step(params, cache, {"token": tok})
                tok = torch.argmax(logits, -1).to(torch.int32)
                out.append(tok)
            return torch.stack(out, 1).cpu().numpy()

        @torch.inference_mode()
        def predict(tokens):
            """One greedy decode step from a fresh cache: (B,) -> (B,)."""
            tok = _tokens(tokens)
            cache = init_cache(tok.shape[0], 4)
            logits, _ = step(params, cache, {"token": tok})
            return torch.argmax(logits, -1).to(torch.int32), zero_stats(device)

        flash, quantized = quantized_param_bytes(params)
        return Lowered(
            predict, flash_bytes=int(flash), sram_bytes=0,
            extras={"cfg": cfg, "params": params, "serve_step": step,
                    "init_cache": init_cache, "generate": generate,
                    "quantized_bytes": int(quantized)})
