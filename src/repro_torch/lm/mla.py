"""Multi-head Latent Attention (DeepSeek-V2/V3).

The PyTorch counterpart of :mod:`repro.lm.mla`.  Queries and keys/values
are projected through low-rank latents; a decode cache holds only the
compressed ``c_kv`` (kv_lora_rank) and the shared rotary key ``k_rope``.

Prefill (:func:`mla_attention`) materializes per-head K/V from the latent,
as the reference does, over q and k of ``qk_nope + qk_rope`` dims (192 in
deepseek-v3) with v zero-padded to the same width and sliced back.  It
takes the routes of :func:`repro_torch.lm.attention.attention`: on a CUDA
tensor one ``flash_attention`` launch (the kernel's dh-192 instance; the
rotary key is repeated to every head, so K/V are not grouped), or with
``impl="ref"`` the kernel's function through the materialized-scores
oracle; on the CPU, or with ``impl="train"`` on any device, the reference's
own branch (blockwise when ``S % chunk == 0 and S > chunk``, else full).

Decode (:func:`mla_decode`) is the absorbed form in float32: ``q_nope`` is
pushed through the ``W_uk`` up-projection once, so scores contract against
the latent cache.  The cache's buffers are updated in place; an int8 cache
stores the latent as int8 with a per-token float32 scale, ``k_rope`` in the
model dtype.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import MLAConfig

from .attention import (_NEG_INF, _kernel_attention, blockwise_attention,
                        full_attention)
from .layers import (apply_rope, draw_device, init_linear, make_norm_params,
                     on_card, rmsnorm, wval)

__all__ = ["mla_params", "mla_attention", "mla_decode", "init_mla_cache"]


def mla_params(generator: torch.Generator, d: int, n_heads: int,
               m: MLAConfig, dtype: torch.dtype, lead=()) -> Dict:
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    dev = draw_device(generator)
    return {
        "wq_a": init_linear(generator, d, m.q_lora_rank, dtype, lead=lead),
        "q_norm": make_norm_params("rmsnorm", m.q_lora_rank, dtype, dev,
                                   lead),
        "wq_b": init_linear(generator, m.q_lora_rank, n_heads * qk, dtype,
                            lead=lead),
        "wkv_a": init_linear(generator, d, m.kv_lora_rank + m.qk_rope_head_dim,
                             dtype, lead=lead),
        "kv_norm": make_norm_params("rmsnorm", m.kv_lora_rank, dtype, dev,
                                    lead),
        "wkv_b": init_linear(generator, m.kv_lora_rank,
                             n_heads * (m.qk_nope_head_dim + m.v_head_dim),
                             dtype, lead=lead),
        "wo": init_linear(generator, n_heads * m.v_head_dim, d, dtype,
                          lead=lead),
    }


def _project_q(p: Dict, x: torch.Tensor, n_heads: int, m: MLAConfig,
               positions: torch.Tensor, rope_theta: float):
    b, s, _ = x.shape
    q_lat = rmsnorm(x @ wval(p["wq_a"], x.dtype), p["q_norm"]["scale"])
    q = (q_lat @ wval(p["wq_b"], x.dtype)).reshape(
        b, s, n_heads, m.qk_nope_head_dim + m.qk_rope_head_dim)
    q_nope = q[..., :m.qk_nope_head_dim]
    q_rope = apply_rope(q[..., m.qk_nope_head_dim:], positions, rope_theta)
    return q_nope, q_rope


def mla_attention(p: Dict, x: torch.Tensor, *, n_heads: int, m: MLAConfig,
                  rope_theta: float, chunk: int = 1024,
                  positions: Optional[torch.Tensor] = None,
                  impl: str = "cuda") -> torch.Tensor:
    """Prefill over x (B, S, d), causal: per-head K/V from the latent."""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    q_nope, q_rope = _project_q(p, x, n_heads, m, positions, rope_theta)

    kv = x @ wval(p["wkv_a"], x.dtype)  # (B, S, kv_lora + rope)
    c_kv = rmsnorm(kv[..., :m.kv_lora_rank], p["kv_norm"]["scale"])
    k_rope = apply_rope(kv[..., None, m.kv_lora_rank:], positions, rope_theta)

    kv_up = (c_kv @ wval(p["wkv_b"], x.dtype)).reshape(
        b, s, n_heads, m.qk_nope_head_dim + m.v_head_dim)
    k_nope = kv_up[..., :m.qk_nope_head_dim]
    v = kv_up[..., m.qk_nope_head_dim:]

    # full q/k with their rotary parts; v zero-padded to the q/k width for
    # the shared attention (the reference's padding), sliced back after
    qk_dim = m.qk_nope_head_dim + m.qk_rope_head_dim
    q = torch.cat([q_nope, q_rope], -1)
    k = torch.cat([k_nope, k_rope.expand(b, s, n_heads, m.qk_rope_head_dim)],
                  -1)
    v_pad = v
    if m.v_head_dim < qk_dim:
        v_pad = torch.nn.functional.pad(v, (0, qk_dim - m.v_head_dim))
    if impl != "train" and on_card(x):
        out = _kernel_attention(q, k, v_pad, True, impl)
    elif s % chunk == 0 and s > chunk:
        out = blockwise_attention(q, k, v_pad, True, chunk)
    else:
        out = full_attention(q, k, v_pad, True)
    out = out[..., :m.v_head_dim].reshape(b, s, n_heads * m.v_head_dim)
    return out @ wval(p["wo"], x.dtype)


def init_mla_cache(batch: int, max_len: int, m: MLAConfig,
                   dtype: torch.dtype, device: torch.device,
                   quantized: bool = False, lead=()) -> Dict:
    """MLA latent cache, with leading (stacked-layer) dims.  ``quantized``
    stores the latent int8 with a per-token float32 scale (the shared
    rotary key stays in the model dtype: it is small)."""
    lead = tuple(lead)
    z = lambda sh, dt: torch.zeros(lead + (batch, max_len) + sh, dtype=dt,
                                   device=device)
    k_rope = z((m.qk_rope_head_dim,), dtype)
    if quantized:
        return {"c_kv_q": z((m.kv_lora_rank,), torch.int8),
                "c_kv_scale": z((1,), torch.float32),
                "k_rope": k_rope}
    return {"c_kv": z((m.kv_lora_rank,), dtype), "k_rope": k_rope}


def mla_decode(p: Dict, x: torch.Tensor, cache: Dict,
               position: torch.Tensor, *, n_heads: int, m: MLAConfig,
               rope_theta: float) -> Tuple[torch.Tensor, Dict]:
    """One-token absorbed decode.  x: (B, 1, d); ``position``: a 0-d
    integer tensor; the cache is written in place at ``position`` (clamped
    to L - 1, as the reference's ``dynamic_update_slice`` clamps it)."""
    b = x.shape[0]
    quantized = "c_kv_q" in cache
    L = cache["c_kv_q" if quantized else "c_kv"].shape[1]
    position = torch.as_tensor(position, device=x.device)
    pos = position.reshape(1, 1).expand(b, 1)
    q_nope, q_rope = _project_q(p, x, n_heads, m, pos, rope_theta)

    kv = x @ wval(p["wkv_a"], x.dtype)
    c_kv_new = rmsnorm(kv[..., :m.kv_lora_rank], p["kv_norm"]["scale"])
    k_rope_new = apply_rope(kv[..., None, m.kv_lora_rank:], pos,
                            rope_theta)[:, :, 0]
    index = torch.clamp_max(position, L - 1).reshape(1).long()

    def upd(buf, new):
        return buf.index_copy_(1, index, new.to(buf.dtype))

    if quantized:
        c32 = c_kv_new.to(torch.float32)
        amax = torch.amax(torch.abs(c32), dim=-1, keepdim=True)
        scale_new = torch.clamp_min(amax, 1e-8) / 127.0
        q_new = torch.clamp(torch.round(c32 / scale_new), -128, 127)
        new_latent = {"c_kv_q": upd(cache["c_kv_q"], q_new),
                      "c_kv_scale": upd(cache["c_kv_scale"], scale_new)}
        # dequantize at use: the resident latent stays int8
        c_kv = (new_latent["c_kv_q"].to(torch.float32)
                * new_latent["c_kv_scale"]).to(x.dtype)
    else:
        c_kv = upd(cache["c_kv"], c_kv_new)
        new_latent = {"c_kv": c_kv}
    k_rope = upd(cache["k_rope"], k_rope_new)

    # absorb W_uk into q: w_kv_b (r, H, dn + dv)
    w_kv_b = wval(p["wkv_b"], x.dtype).reshape(
        m.kv_lora_rank, n_heads, m.qk_nope_head_dim + m.v_head_dim)
    w_uk = w_kv_b[..., :m.qk_nope_head_dim]  # (r, H, dn)
    w_uv = w_kv_b[..., m.qk_nope_head_dim:]  # (r, H, dv)
    q_lat = torch.einsum("bqhd,rhd->bqhr", q_nope, w_uk)  # (B, 1, H, r)

    scale = float(np.float32(1.0 / math.sqrt(m.qk_nope_head_dim
                                             + m.qk_rope_head_dim)))
    c32 = c_kv.to(torch.float32)
    scores = (torch.einsum("bqhr,bkr->bhqk", q_lat.to(torch.float32), c32)
              + torch.einsum("bqhd,bkd->bhqk", q_rope.to(torch.float32),
                             k_rope.to(torch.float32))) * scale
    idx = torch.arange(L, device=x.device)
    scores = torch.where(idx <= position, scores, _NEG_INF)
    pr = torch.softmax(scores, dim=-1)  # (B, H, 1, L)
    ctx = torch.einsum("bhqk,bkr->bqhr", pr, c32)  # the latent context
    out = torch.einsum("bqhr,rhd->bqhd", ctx, w_uv.to(torch.float32))
    out = out.reshape(b, 1, n_heads * m.v_head_dim).to(x.dtype)
    y = out @ wval(p["wo"], x.dtype)
    return y, {**new_latent, "k_rope": k_rope}
