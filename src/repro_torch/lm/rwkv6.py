"""RWKV-6 "Finch": attention-free time mix with a data-dependent decay.

The PyTorch counterpart of :mod:`repro.lm.rwkv6`.  A layer is a time-mix
block (r/k/v/g projections of ddlerp token-shifted inputs, a per-head
matrix-valued WKV state with the per-channel decay ``w_t =
exp(-exp(w0 + lora(x_t)))``) and a channel-mix block (a squared-ReLU FFN
gated by a sigmoid receptance), each after its LayerNorm.

The reference's prefill is a ``lax.scan`` over time of the whole layer.
Only the WKV state update is sequential: the time mix's token shift reads
``LN1`` of the previous position of the layer's *input*, and the channel
mix ``LN2`` of the previous position of ``h = x + att``, and both are known
for the whole sequence once ``att`` is.  So :func:`rwkv6_forward` computes
the norms, ddlerp, the projections, the decay, the group norm, ``wo`` and
the whole channel mix as (B, L, ...) tensor ops, and loops over time only
for the WKV recurrence (:func:`_wkv`): per token ``out_t = r_t . S`` and
``S = S * w_t + k_t v_t^T``, two launches; the bonus term
``(r_t . (u * k_t)) v_t`` is hoisted out of the loop.  That is the same
function with the sums in another order (a test holds it to the
reference's scan within 1e-5); stepping the reference's scan would launch
about 60 ops a token and layer.  The reference has no Pallas kernel here.

The sigmoids go through the configurable gate sigmoid, as in the
reference.  On the card a ``pwl4`` gate launches ``pwl_activation``: the
time mix's SiLU gate as ``silu_pwl4`` (:func:`repro_torch.lm.layers.
gated_silu`) and the channel mix's receptance as ``pwl4``; the other
gates stay in PyTorch ops, and ``fused=False`` (the training route) keeps
every gate op by op, since the kernel has no backward.

Decode (:func:`rwkv6_decode`) is the same layer over one token from the
cache ``(wkv, shift_tm, shift_cm)``, O(1) in the sequence length; it
updates the cache's buffers in place.

**On a mesh** (``rules``; x a DTensor, its batch on the data axes) the
token-shift interpolation runs in one ``local_map`` on each rank's rows,
whole over ``model`` (its ``5 d`` lora columns reshape to (5, d), which a
``model`` shard cuts inside a slot); the r, k, v, g projections and the
decay are DTensor products placed head-aligned (``model`` where it
divides ``n_heads``); the WKV loop and the per-head group norm run in one
more ``local_map`` on the rank's rows and heads, its zero state made
there; the weights' data-axis (FSDP) shards are gathered at use.

Products and the state run in float32 as in the reference, or in float64
for a float64 model (:func:`repro_torch.lm.layers.wide`): at full depth
two float32 evaluations of this function (decode and forward) part by
rounding that the model amplifies, and a float64 run shows that they are
the same function.
"""

from __future__ import annotations

import math
from typing import TYPE_CHECKING, Dict, Optional, Tuple

import torch

from repro_torch.core.activations import get_sigmoid
from repro_torch.kernels import ops
from repro_torch.sharding.rules import gather_fsdp, shard

from . import layers
from .layers import (activation_fn, draw_device, layernorm, local_elementwise,
                     local_heads, wide)

if TYPE_CHECKING:
    from repro_torch.sharding.rules import Rules

__all__ = ["rwkv6_params", "rwkv6_forward", "rwkv6_decode",
           "init_rwkv_cache", "FLOAT32_LEAVES"]

_LORA_DIM = 64

# leaves the reference keeps in float32 whatever the model's dtype
FLOAT32_LEAVES = ("mu", "mu_x", "w0", "u", "ln_x_scale", "cm_mu_k",
                  "cm_mu_r", "ln1_scale", "ln1_bias", "ln2_scale",
                  "ln2_bias")


def rwkv6_params(generator: torch.Generator, d: int, d_ff: int,
                 n_heads: int, dtype: torch.dtype, lead=()) -> Dict:
    """One layer's parameters (the reference's leaves, init scales and
    dtypes), with leading (stacked) dims, on the generator's device."""
    dev, lead = draw_device(generator), tuple(lead)
    head_dim = d // n_heads

    def lin(din, dout):
        w = torch.randn(lead + (din, dout), generator=generator,
                        dtype=torch.float32, device=dev)
        return w.mul_(1.0 / math.sqrt(din)).to(dtype)

    def full(shape, value):
        return torch.full(lead + shape, value, dtype=torch.float32,
                          device=dev)

    return {
        # time mix
        "mu": full((5, d), 0.5),  # ddlerp anchors r, k, v, g, w
        "mu_x": full((d,), 0.5),
        "lora_a": lin(d, _LORA_DIM * 5),
        "lora_b": lin(_LORA_DIM * 5, d * 5) * 0.1,
        "w0": full((d,), -1.0),  # decay base
        "w_lora_a": lin(d, _LORA_DIM),
        "w_lora_b": lin(_LORA_DIM, d) * 0.1,
        "wr": lin(d, d),
        "wk": lin(d, d),
        "wv": lin(d, d),
        "wg": lin(d, d),
        "wo": lin(d, d),
        "u": full((n_heads, head_dim), 0.0),  # bonus
        "ln_x_scale": full((d,), 1.0),  # per-head group norm
        # channel mix
        "cm_mu_k": full((d,), 0.5),
        "cm_mu_r": full((d,), 0.5),
        "cm_wk": lin(d, d_ff),
        "cm_wv": lin(d_ff, d),
        "cm_wr": lin(d, d),
        # the LayerNorms before each block
        "ln1_scale": full((d,), 0.0),
        "ln1_bias": full((d,), 0.0),
        "ln2_scale": full((d,), 0.0),
        "ln2_bias": full((d,), 0.0),
    }


def _f32(w: torch.Tensor) -> torch.Tensor:
    """``w`` in float32 (or the wider float64)."""
    return w.to(wide(w.dtype))


def _w(w: torch.Tensor, rules: "Optional[Rules]") -> torch.Tensor:
    """A weight in float32 for a product; under rules with its data-axis
    (FSDP) shards gathered, as FSDP gathers at use, its ``model`` shards
    kept."""
    return _f32(w if rules is None else gather_fsdp(w))


def _sigmoid(x: torch.Tensor, gate_sigmoid: str,
             fused: bool) -> torch.Tensor:
    """The gate sigmoid: one ``pwl_activation`` launch of ``pwl4`` on the
    card's serving route, else PyTorch ops; on a DTensor, on each rank's
    local shard (:func:`repro_torch.lm.layers.local_elementwise`)."""
    def sig(t):
        if fused and gate_sigmoid == "pwl4" and layers.on_card(t):
            return ops.pwl_activation(t, "pwl4")
        return get_sigmoid(gate_sigmoid)(t)

    return local_elementwise(sig, x)


def _whole(x: torch.Tensor, rules: "Optional[Rules]") -> torch.Tensor:
    """Under rules, the (B, L, n) activation ``x`` whole over ``model``, its
    batch on the data axes; unchanged without rules."""
    return x if rules is None else shard(x, ("batch", None, None), rules)


def _ddlerp(p: Dict, x: torch.Tensor, x_prev: torch.Tensor,
            rules: "Optional[Rules]" = None) -> torch.Tensor:
    """The data-dependent token-shift interpolation: (5, ..., d) float32
    inputs of r, k, v, g and w.  Under rules it runs in one ``local_map``
    on each rank's batch rows, whole over ``model`` (its lora's ``5 d``
    columns reshaped to (5, d), which a ``model`` shard would cut inside a
    slot), its four leaves gathered."""
    leaves = (p["mu_x"], p["lora_a"], p["lora_b"], p["mu"])
    if rules is None:
        return _interpolate(0, 1, x, x_prev, *leaves)
    from torch.distributed.tensor import Shard

    x, x_prev = (_whole(t, rules) for t in (x, x_prev))
    out = [Shard(1) if q.is_shard(0) else q for q in x.placements]
    return local_heads(_interpolate, [out], [x, x_prev], leaves, False)


def _interpolate(part: int, parts: int, x, x_prev, mu_x, lora_a, lora_b,
                 mu) -> torch.Tensor:
    """:func:`_ddlerp`'s body (the heads whole: ``part`` 0 of 1)."""
    diff = _f32(x_prev - x)
    xf = _f32(x)
    xx = xf + diff * mu_x
    lora = torch.tanh(xx @ _f32(lora_a))
    adjust = lora @ _f32(lora_b)
    adjust = adjust.reshape(*adjust.shape[:-1], 5, x.shape[-1])
    mixed = xf[..., None, :] + diff[..., None, :] * (mu + adjust)
    return torch.movedim(mixed, -2, 0)


def _decay(p: Dict, xw: torch.Tensor,
           rules: "Optional[Rules]" = None) -> torch.Tensor:
    """w_t in (0, 1): exp(-exp(w0 + lora(xw)))."""
    lw = _whole(torch.tanh(xw @ _w(p["w_lora_a"], rules)), rules) @ _w(
        p["w_lora_b"], rules)
    return torch.exp(-torch.exp(p["w0"] + lw))


def _wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
         u: torch.Tensor, state: torch.Tensor,
         chunk: int = 64) -> Tuple[torch.Tensor, torch.Tensor]:
    """The WKV recurrence over L tokens.  r, k, v, w: (B, L, H, N) float32;
    u: (H, N); state: (B, H, N, N) float32 (key x value).  Returns the
    (B, L, H, N) outputs ``r_t . (S + u k_t v_t^T)`` and the final state;
    ``state`` itself is not written.  The outer products ``k_t v_t^T`` are
    formed ``chunk`` tokens at a time (one launch), so a token costs two
    launches: ``r_t . S`` and ``S * w_t + k_t v_t^T``."""
    bonus = (r * u * k).sum(-1, keepdim=True) * v
    rt, kt, vt, wt = (t.transpose(0, 1).contiguous() for t in (r, k, v, w))
    outs = []
    for c in range(0, rt.shape[0], chunk):
        kv = kt[c:c + chunk, ..., None] * vt[c:c + chunk, ..., None, :]
        wc = wt[c:c + chunk, ..., None]  # the decay over the key axis
        for t in range(kv.shape[0]):
            outs.append(rt[c + t][..., None, :] @ state)  # (B, H, 1, N)
            state = torch.addcmul(kv[t], state, wc[t])
    out = torch.cat(outs, dim=-2).transpose(1, 2)  # (B, L, H, N)
    return out + bonus, state


def _heads(part: int, parts: int, r, k, v, w, g, *rest):
    """The WKV loop and the per-head group norm on ``part`` of ``parts`` of
    the heads: r, k, v, w, g (B, L, d / parts) this part's; ``rest`` the
    state, this part's (B, H / parts, N, N) (absent: the zero state), then
    u (H, N) and ``ln_x_scale`` (d,) whole.  Returns ((B, L, d / parts),
    the final state)."""
    *state, u, ln_x_scale = rest
    h = u.shape[0] // parts
    b, length, dl = r.shape
    hd = dl // h
    split = lambda t: t.reshape(b, length, h, hd)  # noqa: E731
    if state:
        state = state[0]
    else:
        state = torch.zeros((b, h, hd, hd), dtype=r.dtype, device=r.device)
    out, state = _wkv(split(r), split(k), split(v), split(w),
                      u.narrow(0, part * h, h), state)
    mean = out.mean(-1, keepdim=True)
    var = out.var(-1, keepdim=True, correction=0)
    out = ((out - mean) * torch.rsqrt(var + 1e-5)).reshape(b, length, dl)
    return out * ln_x_scale.narrow(0, part * dl, dl) * g, state


def _time_mix(p: Dict, xn: torch.Tensor, xn_prev: torch.Tensor,
              state: Optional[torch.Tensor], n_heads: int, gate_sigmoid: str,
              fused: bool, rules: "Optional[Rules]" = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """xn, xn_prev: (B, L, d) (the normed input and its token shift) ->
    ((B, L, d) in xn's dtype, the final WKV state); ``state`` None is the
    zero state.  Under rules the WKV loop and the group norm run in one
    ``local_map`` on each rank's batch rows and heads (``model`` where it
    divides ``n_heads``), the projections placed head-aligned for it."""
    xr, xk, xv, xg, xw = _ddlerp(p, xn, xn_prev, rules)
    act = activation_fn("silu", gate_sigmoid, fused)
    ins = [xr @ _w(p["wr"], rules), xk @ _w(p["wk"], rules),
           xv @ _w(p["wv"], rules), _decay(p, xw, rules),
           act(xg @ _w(p["wg"], rules))]
    leaves = (p["u"], p["ln_x_scale"])
    if rules is None:
        out, state = _heads(0, 1, *ins, *(() if state is None else (state,)),
                            *leaves)
    else:
        from repro_torch.sharding.rules import device_mesh, placements

        heads = "model" if rules.resolve("model", n_heads) else None
        ins = [shard(t, ("batch", None, heads), rules) for t in ins]
        b, _, d = xn.shape
        state_axes = ("batch", heads, None, None)
        if state is not None:
            ins.append(shard(state, state_axes, rules))
        state_p = placements(rules.spec(state_axes, (b, n_heads, d // n_heads,
                                                     d // n_heads)),
                             device_mesh(rules.mesh))
        out, state = local_heads(_heads, (ins[0].placements, state_p), ins,
                                 leaves, heads is not None)
    return (out @ _w(p["wo"], rules)).to(xn.dtype), state


def _channel_mix(p: Dict, x: torch.Tensor, x_prev: torch.Tensor,
                 gate_sigmoid: str, fused: bool,
                 rules: "Optional[Rules]" = None) -> torch.Tensor:
    xf = _f32(x)
    diff = _f32(x_prev - x)
    xk = xf + diff * p["cm_mu_k"]
    xr = xf + diff * p["cm_mu_r"]
    k = torch.square(torch.relu(xk @ _w(p["cm_wk"], rules)))
    kv = k @ _w(p["cm_wv"], rules)
    return (_sigmoid(xr @ _w(p["cm_wr"], rules), gate_sigmoid, fused)
            * kv).to(x.dtype)


def _shift(prev: Optional[torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """(B, d) previous position (None: zeros) and (B, L, d) -> each
    position's predecessor, (B, L, d)."""
    first = (torch.zeros_like(x[:, :1]) if prev is None
             else prev[:, None, :].to(x.dtype))
    return torch.cat([first, x[:, :-1]], dim=1)


def _layer(p: Dict, x: torch.Tensor, cache: Optional[Dict], n_heads: int,
           gate_sigmoid: str, fused: bool, rules: "Optional[Rules]" = None):
    """One layer over (B, L, d) after the state ``cache`` (None: the zero
    state): (out, final WKV state, the last position's LN1 and LN2
    outputs)."""
    def prev(key):
        if cache is None:
            return None
        return shard(cache[key], ("batch", None), rules)

    xn = layernorm(x, p["ln1_scale"], p["ln1_bias"])
    att, state = _time_mix(p, xn, _shift(prev("shift_tm"), xn),
                           None if cache is None else cache["wkv"], n_heads,
                           gate_sigmoid, fused, rules)
    h = x + att
    hn = layernorm(h, p["ln2_scale"], p["ln2_bias"])
    ffn = _channel_mix(p, hn, _shift(prev("shift_cm"), hn), gate_sigmoid,
                       fused, rules)
    return h + ffn, state, xn[:, -1], hn[:, -1]


def rwkv6_forward(p: Dict, x: torch.Tensor, n_heads: int,
                  gate_sigmoid: str = "exact", fused: bool = True,
                  rules: "Optional[Rules]" = None) -> torch.Tensor:
    """Full-sequence layer forward from a zero state.  x: (B, L, d) ->
    (B, L, d).  Under ``rules`` (x a DTensor, its batch on the data axes)
    the zero state is made on each rank inside the WKV loop's
    ``local_map``."""
    return _layer(p, x, None, n_heads, gate_sigmoid, fused, rules)[0]


def init_rwkv_cache(batch: int, d: int, n_heads: int, dtype: torch.dtype,
                    device: torch.device, lead=()) -> Dict:
    """The decode state, with leading (stacked) dims: the float32 (or
    float64) WKV state and the two token shifts in the model dtype."""
    hd = d // n_heads
    lead = tuple(lead)
    return {
        "wkv": torch.zeros(lead + (batch, n_heads, hd, hd),
                           dtype=wide(dtype), device=device),
        "shift_tm": torch.zeros(lead + (batch, d), dtype=dtype,
                                device=device),
        "shift_cm": torch.zeros(lead + (batch, d), dtype=dtype,
                                device=device),
    }


def rwkv6_decode(p: Dict, x: torch.Tensor, cache: Dict, n_heads: int,
                 gate_sigmoid: str = "exact",
                 rules: "Optional[Rules]" = None) -> Tuple[torch.Tensor, Dict]:
    """One-token step.  x: (B, 1, d) -> (B, 1, d); the cache's buffers are
    updated in place and returned (under ``rules``, DTensors: each written
    from the step's results redistributed to its own placements)."""
    out, state, xn, hn = _layer(p, x, cache, n_heads, gate_sigmoid, True,
                                rules)
    for k, v in (("wkv", state), ("shift_tm", xn), ("shift_cm", hn)):
        if rules is not None:
            v = v.redistribute(v.device_mesh, cache[k].placements)
        cache[k].copy_(v)
    return out, cache
