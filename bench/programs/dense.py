"""The port's decoder stack with its vision front end (llava-next):
``repro_torch.lm.model.forward(params, batch, cfg)`` on its default kernel
route (``attn_impl="cuda"``: one ``flash_attention`` launch a layer on the
card), on weights and inputs the benchmark draws from the seed."""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.lm import model as lm_model

__all__ = ["arch", "draw_params", "draw_pools", "batch", "run",
           "KERNELS", "PORT_RMS_EPS"]

# the libraries the forward launches on the card (built during set-up)
KERNELS = ("flash_attention",)
# the port's RMSNorm constant (repro_torch.lm.layers.rmsnorm)
PORT_RMS_EPS = 1e-6


def arch(cfg: Dict) -> ArchConfig:
    """The port's configuration for a configuration file's sizes."""
    if cfg["rms_norm_eps"] != PORT_RMS_EPS:
        raise ValueError(f"the port's RMSNorm runs eps {PORT_RMS_EPS} and "
                         f"has no option for it; the file states "
                         f"{cfg['rms_norm_eps']}")
    image = cfg.get("image_seq_length")
    if image and cfg["projector_hidden_size"] != cfg["hidden_size"]:
        raise ValueError("the port's modality_proj is hidden_size wide")
    return ArchConfig(
        name=cfg["name"], family="vlm" if image else "dense",
        n_layers=cfg["num_hidden_layers"], d_model=cfg["hidden_size"],
        n_heads=cfg["num_attention_heads"],
        n_kv_heads=cfg["num_key_value_heads"], d_head=cfg["head_dim"],
        d_ff=cfg["intermediate_size"], vocab_size=cfg["vocab_size"],
        mlp_type="glu", activation=cfg["hidden_act"], norm="rmsnorm",
        rope_theta=float(cfg["rope_theta"]),
        tie_embeddings=bool(cfg["tie_word_embeddings"]),
        sliding_window=cfg.get("sliding_window"),
        modality="vision" if image else None,
        remat=False, dtype=cfg["torch_dtype"])


def draw_params(a: ArchConfig, generator: torch.Generator,
                device: torch.device) -> Dict:
    """The parameter tree ``forward`` takes, drawn on ``device`` in the
    dtypes it is served in, one draw a stacked leaf: the embedding and
    every linear N(0, 1/fan_in), norm scales and biases zero."""

    def fill(meta: Dict) -> Dict:
        out = {}
        for key, leaf in meta.items():
            if isinstance(leaf, dict):
                out[key] = fill(leaf)
            elif key in ("w", "table"):
                fan_in = leaf.shape[-2] if key == "w" else leaf.shape[-1]
                out[key] = torch.randn(
                    leaf.shape, generator=generator, dtype=leaf.dtype,
                    device=device).mul_(1.0 / math.sqrt(fan_in))
            elif key in ("scale", "b", "bias"):
                out[key] = torch.zeros(leaf.shape, dtype=leaf.dtype,
                                       device=device)
            else:
                raise KeyError(f"no draw rule for the leaf {key!r}")
        return out

    return fill(lm_model.abstract_params(a))


def draw_pools(a: ArchConfig, text_pool: int, image_pool: int,
               generator: torch.Generator, device: torch.device,
               text_vocab: Optional[int] = None) -> Dict:
    """Token ids (below ``text_vocab``, else the vocabulary's size) and
    image activations that requests are cut from."""
    pools = {"tokens": torch.randint(0, text_vocab or a.vocab_size,
                                     (text_pool,),
                                     generator=generator, device=device)}
    if a.modality == "vision":
        pools["image"] = torch.randn((image_pool, a.d_model),
                                     generator=generator,
                                     dtype=getattr(torch, a.dtype),
                                     device=device)
    return pools


def batch(pools: Dict, n_image: int, n_text: int, image_offset: int,
          text_offset: int) -> Dict:
    """One request's batch: its tokens and, with an image, its image
    activations, as (1, ...) views of the pools."""
    out = {"tokens": pools["tokens"][text_offset:text_offset + n_text][None]}
    if n_image:
        out["image_embeds"] = pools["image"][
            image_offset:image_offset + n_image][None]
    return out


def run(params: Dict, inputs: Dict, a: ArchConfig,
        attn_impl: Optional[str] = None) -> torch.Tensor:
    """The timed entry: float32 logits (1, positions, vocab)."""
    return lm_model.forward(params, inputs, a, attn_impl=attn_impl or "cuda")
