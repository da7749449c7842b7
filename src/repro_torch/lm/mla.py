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
from typing import TYPE_CHECKING, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import MLAConfig
from repro_torch.sharding.rules import shard

from .attention import (_NEG_INF, _kernel_attention, blockwise_attention,
                        full_attention)
from .layers import (apply_rope, draw_device, init_linear, make_norm_params,
                     on_card, rmsnorm, wval)

if TYPE_CHECKING:
    from repro_torch.sharding.rules import Rules

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


def _heads_axis(rules: "Rules", n_heads: int) -> Optional[str]:
    """``'model'`` where the rules shard ``n_heads`` on it, else None."""
    return "model" if rules.resolve("model", n_heads) is not None else None


def _projections(p: Dict, x: torch.Tensor, n_heads: int, m: MLAConfig,
                 up: bool, rules: "Optional[Rules]"):
    """q (B, S, H, dn + dr), the latent input ``kv`` (B, S, r + dr) before
    its norm and RoPE, and with ``up`` the per-head K/V ``kv_up`` (B, S, H,
    dn + dv).  Under rules each product is placed before it is split into
    heads: the low-rank latents replicated over ``model`` (their norms see
    whole rows, never a partial sum), the per-head products with their
    heads on ``model`` where ``n_heads`` divides (a column shard that
    splits a head cannot be reshaped)."""
    b, s, _ = x.shape
    heads = _heads_axis(rules, n_heads) if rules is not None else None

    def place(y, axis):
        return shard(y, ("batch", None, axis), rules)

    q_lat = rmsnorm(place(x @ wval(p["wq_a"], x.dtype), None),
                    p["q_norm"]["scale"])
    q = place(q_lat @ wval(p["wq_b"], x.dtype), heads).reshape(
        b, s, n_heads, m.qk_nope_head_dim + m.qk_rope_head_dim)
    kv = place(x @ wval(p["wkv_a"], x.dtype), None)
    if not up:
        return q, kv
    c_kv = rmsnorm(kv[..., :m.kv_lora_rank], p["kv_norm"]["scale"])
    kv_up = place(c_kv @ wval(p["wkv_b"], x.dtype), heads).reshape(
        b, s, n_heads, m.qk_nope_head_dim + m.v_head_dim)
    return q, kv, kv_up


def _attend_heads(q: torch.Tensor, kv: torch.Tensor, kv_up: torch.Tensor,
                  positions: Optional[torch.Tensor], m: MLAConfig,
                  rope_theta: float, chunk: int, impl: str) -> torch.Tensor:
    """RoPE and causal attention over the heads of ``q`` and ``kv_up`` (all
    of them, or a rank's local heads) -> (B, S, H, dv): q and k of
    ``qk_nope + qk_rope`` dims with the shared rotary key repeated to every
    head, v zero-padded to the same width (the reference's padding) and
    sliced back."""
    b, s, h, _ = q.shape
    dn = m.qk_nope_head_dim
    if positions is None:
        positions = torch.arange(s, device=q.device)[None, :]
    q_rope = apply_rope(q[..., dn:], positions, rope_theta)
    k_rope = apply_rope(kv[..., None, m.kv_lora_rank:], positions, rope_theta)
    qk_dim = dn + m.qk_rope_head_dim
    q = torch.cat([q[..., :dn], q_rope], -1)
    k = torch.cat([kv_up[..., :dn],
                   k_rope.expand(b, s, h, m.qk_rope_head_dim)], -1)
    v_pad = kv_up[..., dn:]
    if m.v_head_dim < qk_dim:
        v_pad = torch.nn.functional.pad(v_pad, (0, qk_dim - m.v_head_dim))
    if impl != "train" and on_card(q):
        out = _kernel_attention(q, k, v_pad, True, impl)
    elif s % chunk == 0 and s > chunk:
        out = blockwise_attention(q, k, v_pad, True, chunk)
    else:
        out = full_attention(q, k, v_pad, True)
    return out[..., :m.v_head_dim]


def mla_attention(p: Dict, x: torch.Tensor, *, n_heads: int, m: MLAConfig,
                  rope_theta: float, chunk: int = 1024,
                  positions: Optional[torch.Tensor] = None,
                  impl: str = "cuda",
                  rules: "Optional[Rules]" = None) -> torch.Tensor:
    """Prefill over x (B, S, d), causal: per-head K/V from the latent.
    Under ``rules`` RoPE and the attention run on each rank's local heads
    through ``local_map`` (on the card one dh-192 launch a layer and
    rank), the shared rotary key replicated over ``model``."""
    b, s, _ = x.shape
    q, kv, kv_up = _projections(p, x, n_heads, m, True, rules)

    def attend(q, kv, kv_up):
        return _attend_heads(q, kv, kv_up, positions, m, rope_theta, chunk,
                             impl)

    if rules is None:
        out = attend(q, kv, kv_up)
    else:
        from torch.distributed.tensor import Partial, Shard
        from torch.distributed.tensor.experimental import local_map

        # the rotary key feeds only a rank's local heads: where the heads
        # are split, its gradient is a partial sum over their ranks
        kv_grad = [Partial() if qp == Shard(2) else kp
                   for qp, kp in zip(q.placements, kv.placements)]
        out = local_map(attend, out_placements=list(q.placements),
                        in_placements=(q.placements, kv.placements,
                                       kv_up.placements),
                        in_grad_placements=(q.placements, kv_grad,
                                            kv_up.placements),
                        device_mesh=q.device_mesh)(q, kv, kv_up)
    out = out.reshape(b, s, n_heads * m.v_head_dim)
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
               rope_theta: float, rules: "Optional[Rules]" = None
               ) -> Tuple[torch.Tensor, Dict]:
    """One-token absorbed decode.  x: (B, 1, d); ``position``: a 0-d
    integer tensor; the cache is written in place at ``position`` (clamped
    to L - 1, as the reference's ``dynamic_update_slice`` clamps it).

    Under ``rules`` the cache entries and ``position`` are DTensors (the
    latent placed by ``cache_specs``: the batch on the data axes, the
    cache length on ``model``), and the step runs on each rank's local
    heads through ``local_map`` over the latent gathered along its length:
    each rank computes the single-device softmax over every position, so
    no cross-shard max and sum is needed.  The returned entries are new
    DTensors, placed with the batch alone."""
    b = x.shape[0]
    q, kv = _projections(p, x, n_heads, m, False, rules)
    w_kv_b = wval(p["wkv_b"], x.dtype)
    keys = sorted(cache)

    def step(q, kv, w_kv_b, scale, position, *entries):
        out, new = _absorbed_step(q, kv, w_kv_b, scale, position,
                                  dict(zip(keys, entries)), m, rope_theta)
        return (out,) + tuple(new[k] for k in keys)

    if rules is None:
        position = torch.as_tensor(position, device=x.device)
        out, *entries = step(q, kv, w_kv_b, p["kv_norm"]["scale"], position,
                             *(cache[k] for k in keys))
    else:
        from torch.distributed.tensor.experimental import local_map

        heads = _heads_axis(rules, n_heads)
        w_kv_b = shard(w_kv_b, (None, heads), rules)
        scale = shard(p["kv_norm"]["scale"], (None,), rules)
        position = shard(position, (), rules)
        entries = [shard(cache[k], ("batch", None, None), rules)
                   for k in keys]
        out, *entries = local_map(
            step, out_placements=(q.placements,) + tuple(
                e.placements for e in entries),
            in_placements=(q.placements, kv.placements, w_kv_b.placements,
                           scale.placements, position.placements) + tuple(
                               e.placements for e in entries),
            device_mesh=q.device_mesh)(q, kv, w_kv_b, scale, position,
                                       *entries)
    out = out.reshape(b, 1, n_heads * m.v_head_dim)
    y = out @ wval(p["wo"], x.dtype)
    return y, dict(zip(keys, entries))


def _absorbed_step(q: torch.Tensor, kv: torch.Tensor, w_kv_b: torch.Tensor,
                   norm_scale: torch.Tensor, position: torch.Tensor,
                   cache: Dict, m: MLAConfig, rope_theta: float):
    """:func:`mla_decode` between its projections, over the heads of ``q``
    (all of them, or a rank's local heads, whose columns ``w_kv_b`` holds):
    the latent's norm and RoPE at ``position``, the cache update and the
    absorbed attention -> ((B, 1, H, dv) heads in the model dtype, the new
    cache entries)."""
    b, _, h, _ = q.shape
    dn, r = m.qk_nope_head_dim, m.kv_lora_rank
    quantized = "c_kv_q" in cache
    L = cache["c_kv_q" if quantized else "c_kv"].shape[1]
    pos = position.reshape(1, 1).expand(b, 1)
    q_nope = q[..., :dn]
    q_rope = apply_rope(q[..., dn:], pos, rope_theta)
    c_kv_new = rmsnorm(kv[..., :r], norm_scale)
    k_rope_new = apply_rope(kv[..., None, r:], pos, rope_theta)[:, :, 0]
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
                * new_latent["c_kv_scale"]).to(q.dtype)
    else:
        c_kv = upd(cache["c_kv"], c_kv_new)
        new_latent = {"c_kv": c_kv}
    k_rope = upd(cache["k_rope"], k_rope_new)

    # absorb W_uk into q: w_kv_b (r, H, dn + dv)
    w_kv_b = w_kv_b.reshape(r, h, dn + m.v_head_dim)
    w_uk = w_kv_b[..., :dn]  # (r, H, dn)
    w_uv = w_kv_b[..., dn:]  # (r, H, dv)
    q_lat = torch.einsum("bqhd,rhd->bqhr", q_nope, w_uk)  # (B, 1, H, r)

    scale = float(np.float32(1.0 / math.sqrt(dn + m.qk_rope_head_dim)))
    c32 = c_kv.to(torch.float32)
    scores = (torch.einsum("bqhr,bkr->bhqk", q_lat.to(torch.float32), c32)
              + torch.einsum("bqhd,bkd->bhqk", q_rope.to(torch.float32),
                             k_rope.to(torch.float32))) * scale
    idx = torch.arange(L, device=q.device)
    scores = torch.where(idx <= position, scores, _NEG_INF)
    pr = torch.softmax(scores, dim=-1)  # (B, H, 1, L)
    ctx = torch.einsum("bhqk,bkr->bqhr", pr, c32)  # the latent context
    out = torch.einsum("bqhr,rhd->bqhd", ctx, w_uv.to(torch.float32))
    return out.to(q.dtype), {**new_latent, "k_rope": k_rope}
