"""Zamba2's published hybrid (``block_pattern "zamba2"``):
``repro_torch.lm.model.forward(params, batch, cfg)`` on its default
kernel route (``attn_impl="cuda"``: one ``flash_attention`` launch on the
dh-224 instance a shared-block call), on weights and inputs the benchmark
draws from the seed.  The inputs are :mod:`.dense`'s: token windows of one
pool, text only."""

from __future__ import annotations

import math
from typing import Dict

import torch

from repro_torch.configs.base import (ArchConfig, SharedBlockConfig, SSMConfig,
                                      Zamba2ArchConfig)
from repro_torch.lm import model as lm_model

from .dense import batch, draw_pools  # noqa: F401  (this family's too)

__all__ = ["arch", "draw_params", "draw_pools", "batch", "run", "KERNELS"]

# the libraries the forward launches on the card (built during set-up)
KERNELS = ("flash_attention",)
# mamba_ssm's dt init: (time_step_min, time_step_max, time_step_floor)
TIME_STEP = (1e-3, 0.1, 1e-4)


def arch(cfg: Dict) -> ArchConfig:
    """The port's configuration for a configuration file's keys (HF's
    ``Zamba2Config``), after the checks that the file is the shape this
    route runs."""
    d, heads, dh = (cfg["hidden_size"], cfg["num_attention_heads"],
                    cfg["attention_head_dim"])
    hybrid = tuple(cfg["hybrid_layer_ids"])
    kinds = cfg["layers_block_type"]
    if cfg["attention_hidden_size"] != 2 * d or heads * dh != 2 * d:
        raise ValueError("the shared block attends over concat(x, emb): "
                         "attention_hidden_size = heads x dh = 2 hidden_size")
    if (len(kinds) != cfg["num_hidden_layers"]
            or [i for i, k in enumerate(kinds) if k == "hybrid"]
            != list(hybrid)):
        raise ValueError("layers_block_type disagrees with hybrid_layer_ids")
    d_in = cfg["mamba_expand"] * d
    if d_in // cfg["mamba_headdim"] != cfg["n_mamba_heads"]:
        raise ValueError("n_mamba_heads must be expand x hidden / headdim")
    if cfg["hidden_act"] != "gelu" or cfg["ffn_hidden_size"] != \
            cfg["intermediate_size"]:
        raise ValueError("the route runs a GeGLU of exact GELU, one width")
    if (cfg["time_step_min"], cfg["time_step_max"],
            cfg["time_step_floor"]) != TIME_STEP:
        raise ValueError(f"draw_params draws dt from {TIME_STEP}")
    return Zamba2ArchConfig(
        name=cfg["name"], family="hybrid", n_layers=cfg["num_hidden_layers"],
        d_model=d, n_heads=heads, n_kv_heads=cfg["num_key_value_heads"],
        d_head=dh, d_ff=cfg["intermediate_size"],
        vocab_size=cfg["vocab_size"], mlp_type="glu",
        activation="gelu_exact", norm="rmsnorm",
        norm_eps=float(cfg["rms_norm_eps"]),
        rope_theta=float(cfg["rope_theta"]),
        tie_embeddings=bool(cfg["tie_word_embeddings"]),
        ssm=SSMConfig(d_state=cfg["mamba_d_state"],
                      d_conv=cfg["mamba_d_conv"],
                      expand=cfg["mamba_expand"],
                      head_dim=cfg["mamba_headdim"],
                      n_groups=cfg["mamba_ngroups"],
                      chunk=cfg["chunk_size"]),
        shared=SharedBlockConfig(
            d_attn=cfg["attention_hidden_size"], layers=hybrid,
            attn_scale=(dh / 2) ** -0.5, n_blocks=cfg["num_mem_blocks"],
            adapter_rank=cfg["adapter_rank"]),
        block_pattern="zamba2", remat=False, dtype=cfg["torch_dtype"])


def draw_params(a: ArchConfig, generator: torch.Generator,
                device: torch.device) -> Dict:
    """The parameter tree ``forward`` takes, drawn on ``device`` in the
    dtypes it is served in, one draw a stacked leaf: the embedding and
    every linear N(0, 1/fan_in), the conv's taps N(0, 1/d_conv), norm
    scales and the conv's bias zero; ``A_log``, ``dt_bias`` and ``D`` as
    mamba_ssm initialises them (A uniform in [1, 16]; dt log-uniform in
    [time_step_min, time_step_max], floored at time_step_floor
    (:data:`TIME_STEP`, the file's, which :func:`arch` checks), stored as
    its inverse softplus; D one), so the state carries across chunks as in
    a trained model."""

    def fill(meta: Dict) -> Dict:
        out = {}
        for key, leaf in meta.items():
            if isinstance(leaf, dict):
                out[key] = fill(leaf)
                continue
            shape, dt = leaf.shape, leaf.dtype
            if key in ("w", "table", "conv_w"):
                fan_in = {"w": shape[-2], "table": shape[-1],
                          "conv_w": shape[-2]}[key]
                out[key] = torch.randn(shape, generator=generator, dtype=dt,
                                       device=device).mul_(
                                           1.0 / math.sqrt(fan_in))
            elif key in ("scale", "norm_scale", "conv_b"):
                out[key] = torch.zeros(shape, dtype=dt, device=device)
            elif key == "D":
                out[key] = torch.ones(shape, dtype=dt, device=device)
            elif key == "A_log":
                out[key] = torch.log(torch.rand(
                    shape, generator=generator, dtype=dt,
                    device=device).mul_(15.0).add_(1.0))
            elif key == "dt_bias":
                lo, hi, floor = (math.log(TIME_STEP[0]),
                                 math.log(TIME_STEP[1]), TIME_STEP[2])
                t = torch.exp(torch.rand(shape, generator=generator,
                                         dtype=dt, device=device)
                              * (hi - lo) + lo).clamp_(min=floor)
                out[key] = t + torch.log(-torch.expm1(-t))
            else:
                raise KeyError(f"no draw rule for the leaf {key!r}")
        return out

    return fill(lm_model.abstract_params(a))


def run(params: Dict, inputs: Dict, a: ArchConfig,
        attn_impl: str = None) -> torch.Tensor:
    """The timed entry: float32 logits (1, positions, vocab)."""
    return lm_model.forward(params, inputs, a, attn_impl=attn_impl or "cuda")
