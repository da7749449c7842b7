"""Attention: GQA with RoPE, prefill through the flash_attention kernel,
cached decode.

The PyTorch counterpart of :mod:`repro.lm.attention`.  Prefill
(:func:`attention`) routes by where its tensors lie:

* on a CUDA tensor, the hand-written ``flash_attention`` kernel
  (:func:`repro_torch.kernels.ops.flash_attention`) on (B*Hq, S, dh)
  queries and (B*Hkv, S, dh) keys and values, whatever S is: K/V heads are
  not repeated, the kernel groups the G = Hq / Hkv query heads of each KV
  head itself (query row bh reads KV row bh // G).  A sliding ``window``
  (zamba2's shared block) is the kernel's runtime argument: the same one
  launch, with the key tiles before each query tile's window skipped.  A
  kernel that fails to build or launch raises; nothing falls back;
* on the CPU, the reference's own branch: the streaming-softmax
  :func:`blockwise_attention` when ``S % chunk == 0 and S > chunk``, else
  :func:`full_attention` with materialized scores, each with the window;
* with ``impl="train"`` (the training route of
  :func:`repro_torch.lm.model.loss_fn`), the CPU branch's functions on
  either device: autograd differentiates them, as JAX differentiates the
  reference's, and the kernel has no backward.

Decode (:func:`decode_attention`) computes one query against the cache in
grouped form (no KV head replication) and updates the cache's buffers in
place: a KV cache is the largest decode buffer, and the reference's
functional update would copy it every step.

Under ``rules`` (DTensor activations on a mesh) the projections run on
DTensors, and everything between them — RoPE, the attention (the kernel on
the card), the cache update — runs on each rank's local shard through
``local_map``: the batch on the data axes, the heads on ``model`` where the
rules shard both ``n_heads`` and ``n_kv_heads``, else replicated.  The
sequence and the cache length are never split there, so a local shard
attends exactly as the whole does.
"""

from __future__ import annotations

import math
from typing import TYPE_CHECKING, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.spans import span

from .layers import apply_linear, apply_rope, init_linear, on_card

if TYPE_CHECKING:
    from repro_torch.sharding.rules import Rules

__all__ = ["attn_params", "attention", "blockwise_attention",
           "full_attention", "decode_attention", "init_kv_cache"]

_NEG_INF = -1e30


def _scale(dh: int, scale: Optional[float] = None) -> float:
    """``scale``, or the default ``float32(1/sqrt(dh))``."""
    return float(np.float32(1.0 / math.sqrt(dh))) if scale is None else scale


def attn_params(generator: torch.Generator, d: int, n_heads: int,
                n_kv_heads: int, head_dim: int, dtype: torch.dtype,
                qkv_bias: bool = False, lead=()) -> Dict:
    return {
        "wq": init_linear(generator, d, n_heads * head_dim, dtype,
                          bias=qkv_bias, lead=lead),
        "wk": init_linear(generator, d, n_kv_heads * head_dim, dtype,
                          bias=qkv_bias, lead=lead),
        "wv": init_linear(generator, d, n_kv_heads * head_dim, dtype,
                          bias=qkv_bias, lead=lead),
        "wo": init_linear(generator, n_heads * head_dim, d, dtype, lead=lead),
    }


def _split_heads(x: torch.Tensor, n: int) -> torch.Tensor:
    b, s, _ = x.shape
    return x.reshape(b, s, n, -1)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, s, h, dh = x.shape
    return x.reshape(b, s, h * dh)


def _grouped_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q: (B,Sq,Hkv,G,dh), k: (B,Sk,Hkv,dh) -> scores (B,Hkv,G,Sq,Sk) f32."""
    return torch.einsum("bqhgd,bkhd->bhgqk", q.to(torch.float32),
                        k.to(torch.float32))


def _grouped_out(p: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """p: (B,Hkv,G,Sq,Sk) f32, v: (B,Sk,Hkv,dh) -> (B,Sq,Hkv,G,dh)."""
    return torch.einsum("bhgqk,bkhd->bqhgd", p, v.to(torch.float32))


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool, chunk: int,
                        window: Optional[int] = None,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Streaming-softmax attention, chunk by chunk (the reference's scan).

    q: (B, S, Hq, dh); k, v: (B, S, Hkv, dh).  Returns (B, S, Hq, dh).
    ``chunk`` must divide S.  ``window``: sliding-window size (None = full).
    ``scale``: the scores' factor (default ``float32(1/sqrt(dh))``).
    """
    b, s, hq, dh = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    scale = _scale(dh, scale)
    n = s // chunk
    qg = q.reshape(b, s, hkv, g, dh)
    base = torch.arange(chunk, device=q.device)
    outs = []
    for qi in range(n):
        qc = qg[:, qi * chunk:(qi + 1) * chunk]
        q_pos = qi * chunk + base
        m = torch.full((b, hkv, g, chunk), _NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((b, hkv, g, chunk, dh), dtype=torch.float32,
                          device=q.device)
        # every kv chunk, as the reference's static-length scan does (a
        # chunk above the diagonal leaves m, l and acc exactly as they were)
        for ki in range(n):
            kc = k[:, ki * chunk:(ki + 1) * chunk]
            vc = v[:, ki * chunk:(ki + 1) * chunk]
            k_pos = ki * chunk + base
            scores = _grouped_scores(qc, kc) * scale
            mask = torch.ones((chunk, chunk), dtype=torch.bool,
                              device=q.device)
            if causal:
                mask &= q_pos[:, None] >= k_pos[None, :]
            if window is not None:
                mask &= (q_pos[:, None] - k_pos[None, :]) < window
            scores = torch.where(mask, scores, _NEG_INF)
            m_new = torch.maximum(m, scores.amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(scores - m_new[..., None])
            l = l * alpha + p.sum(-1)
            pv = torch.einsum("bhgqk,bkhd->bhgqd", p, vc.to(torch.float32))
            acc = acc * alpha[..., None] + pv
            m = m_new
        out = acc / torch.clamp_min(l[..., None], 1e-30)
        # (B, Hkv, G, chunk, dh) -> (B, chunk, Hkv, G, dh)
        outs.append(out.permute(0, 3, 1, 2, 4))
    out = torch.cat(outs, dim=1).reshape(b, s, hq, dh)
    return out.to(q.dtype)


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool, window: Optional[int] = None,
                   scale: Optional[float] = None) -> torch.Tensor:
    """Materialized-scores attention for short sequences."""
    b, s, hq, dh = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, s, hkv, hq // hkv, dh)
    scores = _grouped_scores(qg, k) * _scale(dh, scale)
    pos = torch.arange(s, device=q.device)
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= pos[:, None] >= pos[None, :]
    if window is not None:
        mask &= (pos[:, None] - pos[None, :]) < window
    scores = torch.where(mask, scores, _NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = _grouped_out(p, v)  # (B, Sq, Hkv, G, dh) — already query-major
    return out.reshape(b, s, hq, dh).to(q.dtype)


def _kernel_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool, impl: str,
                      window: Optional[int] = None,
                      scale: Optional[float] = None) -> torch.Tensor:
    """One ``flash_attention`` dispatch over (B*Hq, S, dh) queries and
    (B*Hkv, S, dh) keys and values: the kernel groups the G = Hq / Hkv
    query heads of each KV head itself (query head h reads KV head h // G,
    as the grouped form does), within ``window`` when one is given."""
    b, s, hq, dh = q.shape

    def fold(t):  # (B, S, H, dh) -> contiguous (B*H, S, dh)
        return t.transpose(1, 2).reshape(b * t.shape[2], s, dh)

    # the kernel's default scale unless the model states another
    extra = {} if scale is None else {"scale": scale}
    out = ops.flash_attention(fold(q), fold(k), fold(v), causal, impl=impl,
                              window=window, **extra)
    return out.view(b, hq, s, dh).transpose(1, 2)


def _heads_axis(rules: "Rules", n_heads: int, n_kv_heads: int):
    """``'model'`` where the rules shard both head counts on it, else None
    (the heads replicated)."""
    both = (rules.resolve("model", n_heads) is not None
            and rules.resolve("model", n_kv_heads) is not None)
    return "model" if both else None


def _local(fn, outs: int, *xs):
    """``fn`` on each rank's local shards of the DTensors ``xs`` (already
    placed as ``fn`` needs), its ``outs`` results placed as ``xs[0]``."""
    from torch.distributed.tensor.experimental import local_map

    # one output's placements go as a list: a tuple lists several outputs'
    out_p = list(xs[0].placements) if outs == 1 else (
        (xs[0].placements,) * outs)
    return local_map(fn, out_placements=out_p,
                     in_placements=tuple(x.placements for x in xs),
                     device_mesh=xs[0].device_mesh)(*xs)


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            positions: Optional[torch.Tensor], rope_theta: float,
            causal: bool, chunk: int, window: Optional[int],
            impl: str, scale: Optional[float] = None,
            cache: Optional[Dict] = None) -> torch.Tensor:
    """RoPE and attention over (B, S, H, dh) heads: the kernel on a CUDA
    tensor (but for ``impl="train"``), else the reference's branch.
    ``cache``: a KV cache slot whose first S positions take the roped keys
    and the values."""
    s = q.shape[1]
    if positions is None:
        positions = torch.arange(s, device=q.device)[None, :]
    with span("lm.rope"):
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)
    if cache is not None:
        if "k" not in cache:
            raise ValueError("a prefill writes a bfloat16 or float32 KV "
                             "cache, not an int8 one")
        cache["k"][:, :s].copy_(k)
        cache["v"][:, :s].copy_(v)
    if impl != "train" and on_card(q):
        return _kernel_attention(q, k, v, causal, impl, window, scale)
    if s % chunk == 0 and s > chunk:
        return blockwise_attention(q, k, v, causal, chunk, window, scale)
    return full_attention(q, k, v, causal, window, scale)


def attention(params: Dict, x: torch.Tensor, *, n_heads: int,
              n_kv_heads: int, head_dim: int, rope_theta: float,
              causal: bool = True, chunk: int = 1024,
              window: Optional[int] = None,
              positions: Optional[torch.Tensor] = None,
              impl: str = "cuda", rules: "Optional[Rules]" = None,
              scale: Optional[float] = None,
              cache: Optional[Dict] = None) -> torch.Tensor:
    """Self-attention over a full sequence (prefill).  ``impl`` is the
    kernel route on a CUDA tensor (``"cuda"`` launches the kernel, ``"ref"``
    computes its function through the materialized-scores oracle);
    ``"train"`` takes the reference's branch on any device.  ``scale``: the
    scores' factor (default ``float32(1/sqrt(head_dim))``).  ``cache``: a
    KV cache slot (B, L >= S, Hkv, dh) whose first S positions are written
    with the roped keys and the values (a prefill into the decode cache;
    not under rules).  Under ``rules`` the heads attend on each rank's
    local shard (the module docstring)."""
    q, k, v = _project(params, x, n_heads, n_kv_heads, rules)

    def attend(q, k, v):
        return _attend(q, k, v, positions, rope_theta, causal, chunk, window,
                       impl, scale, cache)

    if rules is None:
        out = attend(q, k, v)
    else:
        out = _local(attend, 1, q, k, v)
    return apply_linear(params["wo"], _merge_heads(out))


def _project(params: Dict, x: torch.Tensor, n_heads: int, n_kv_heads: int,
             rules: "Optional[Rules]"):
    """q (B, S, Hq, dh), k and v (B, S, Hkv, dh).  Under rules each
    projection is placed for the local attention before it is split into
    heads: the batch on the data axes, and the heads' columns on ``model``
    where the rules shard both head counts, else replicated (a column
    shard that splits a head cannot be reshaped into heads)."""
    ys = [apply_linear(params[w], x) for w in ("wq", "wk", "wv")]
    if rules is not None:
        from repro_torch.sharding.rules import shard

        heads = _heads_axis(rules, n_heads, n_kv_heads)
        ys = [shard(y, ("batch", None, heads), rules) for y in ys]
    return (_split_heads(ys[0], n_heads), _split_heads(ys[1], n_kv_heads),
            _split_heads(ys[2], n_kv_heads))


# --------------------------------------------------------------------------
# Decode path
# --------------------------------------------------------------------------
def init_kv_cache(batch: int, max_len: int, n_kv_heads: int, head_dim: int,
                  dtype: torch.dtype, device: torch.device,
                  quantized: bool = False, lead=()) -> Dict:
    """KV cache, with leading (stacked-layer) dims.  ``quantized``: int8
    entries + a per-(token, head) float32 scale."""
    shape = tuple(lead) + (batch, max_len, n_kv_heads, head_dim)
    sshape = shape[:-1] + (1,)
    z = lambda sh, dt: torch.zeros(sh, dtype=dt, device=device)
    if quantized:
        return {"k_q": z(shape, torch.int8),
                "k_scale": z(sshape, torch.float32),
                "v_q": z(shape, torch.int8),
                "v_scale": z(sshape, torch.float32)}
    return {"k": z(shape, dtype), "v": z(shape, dtype)}


def _quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, 1, H, dh) -> int8 values + per-(token, head) scale."""
    x32 = x.to(torch.float32)
    amax = torch.amax(torch.abs(x32), dim=-1, keepdim=True)
    scale = torch.clamp_min(amax, 1e-8) / 127.0
    q = torch.clamp(torch.round(x32 / scale), -128, 127)
    return q.to(torch.int8), scale


def decode_attention(params: Dict, x: torch.Tensor, cache: Dict,
                     position: torch.Tensor, *, n_heads: int,
                     n_kv_heads: int, head_dim: int, rope_theta: float,
                     window: Optional[int] = None,
                     rules: "Optional[Rules]" = None,
                     scale: Optional[float] = None
                     ) -> Tuple[torch.Tensor, Dict]:
    """One-token decode (``scale``: the scores' factor, default
    ``float32(1/sqrt(head_dim))``).  x: (B, 1, d); cache K/V: (B, L, Hkv, dh);
    ``position``: a 0-d integer tensor.

    Full-length cache (L > position): write at ``position`` in place and
    attend over the first ``position`` + 1 slots.  Sliding-window cache
    (``window`` set and L <= window): a shift buffer ordered oldest to
    newest, shifted left one slot per step once full (a new buffer, which
    the returned cache holds); keys are stored RoPE'd at their absolute
    positions.  The write index is clamped to L - 1, as the reference's
    ``dynamic_update_slice`` clamps it.  Under ``rules`` the cache entries
    and ``position`` are DTensors, and the step runs on each rank's local
    shard (a cache placed otherwise is redistributed for it, and the
    returned entries are new DTensors).
    """
    b = x.shape[0]
    # (B, 1, Hq, dh), (B, 1, Hkv, dh) twice
    q, k_new, v_new = _project(params, x, n_heads, n_kv_heads, rules)
    keys = sorted(cache)

    def step(q, k_new, v_new, position, *entries):
        out, new = _decode_step(q, k_new, v_new, dict(zip(keys, entries)),
                                position, head_dim, rope_theta, window,
                                scale)
        return (out,) + tuple(new[k] for k in keys)

    if rules is None:
        position = torch.as_tensor(position, device=x.device)
        out, *entries = step(q, k_new, v_new, position,
                             *(cache[k] for k in keys))
    else:
        from repro_torch.sharding.rules import shard

        axes = ("batch", None, _heads_axis(rules, n_heads, n_kv_heads), None)
        out, *entries = _local(step, 1 + len(keys), q, k_new, v_new,
                               shard(position, (), rules),
                               *(shard(cache[k], axes, rules) for k in keys))
    out = out.reshape(b, 1, n_heads * head_dim)
    y = apply_linear(params["wo"], out.to(x.dtype))
    return y, dict(zip(keys, entries))


def _decode_step(q, k_new, v_new, cache, position, head_dim, rope_theta,
                 window, scale=None):
    """:func:`decode_attention` between its projections: RoPE at
    ``position``, the cache update and the attention -> (float32 (B, 1, Hq,
    dh) heads, the new cache entries)."""
    b = q.shape[0]
    quantized = "k_q" in cache
    L = cache["k_q" if quantized else "k"].shape[1]
    windowed = window is not None and L <= window
    pos = position.reshape(1, 1).expand(b, 1)
    q = apply_rope(q, pos, rope_theta)
    k_new = apply_rope(k_new, pos, rope_theta)

    if windowed:
        full = position >= L
        slot = torch.clamp_max(position, L - 1)
        base = {kk: torch.where(full, torch.roll(cc, -1, dims=1), cc)
                for kk, cc in cache.items()}
    else:
        slot = position
        base = cache
    index = torch.clamp_max(slot, L - 1).reshape(1).long()

    def upd(buf, new):
        return buf.index_copy_(1, index, new.to(buf.dtype))

    if quantized:
        kq_new, ks_new = _quantize_kv(k_new)
        vq_new, vs_new = _quantize_kv(v_new)
        new_cache = {"k_q": upd(base["k_q"], kq_new),
                     "k_scale": upd(base["k_scale"], ks_new),
                     "v_q": upd(base["v_q"], vq_new),
                     "v_scale": upd(base["v_scale"], vs_new)}
        # dequantize at use: the resident buffer stays int8 (paper C1)
        k = (new_cache["k_q"].to(torch.float32)
             * new_cache["k_scale"]).to(q.dtype)
        v = (new_cache["v_q"].to(torch.float32)
             * new_cache["v_scale"]).to(q.dtype)
    else:
        k = upd(base["k"], k_new)
        v = upd(base["v"], v_new)
        new_cache = {"k": k, "v": v}
    hkv = k.shape[2]  # this rank's KV heads (all of them but on a mesh)
    qg = q.reshape(b, 1, hkv, q.shape[2] // hkv, head_dim)
    scores = _grouped_scores(qg, k) * _scale(head_dim, scale)  # (B,Hkv,G,1,L)
    idx = torch.arange(L, device=q.device)
    valid = idx[None, :] <= slot
    if window is not None and not windowed:
        valid &= (position - idx[None, :]) < window
    scores = torch.where(valid, scores, _NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = _grouped_out(p, v)  # (B, 1, Hkv, G, dh) — already query-major
    return out.reshape(b, 1, q.shape[2], head_dim), new_cache
