"""Mamba-2 (SSD) block: the chunked state-space scan for prefill and
training, and the O(1)-state recurrent decode step.

The PyTorch counterpart of :mod:`repro.lm.mamba2` (Dao & Gu,
arXiv:2405.21060): within a chunk the quadratic term, between chunks the
low-rank state passing, the chunk decay exact ``exp(segsum(A))``.  The
reference has no Pallas kernel for it: the scan is einsums in float32 on
either device, as in the reference (a float32 product on the card runs in
full float32 unless the process turned TF32 on; the reference's
``preferred`` precision is float32 too).

:func:`_ssd_chunked`'s four-operand einsum ``bclhn,bcshn,bhcls,bcshp`` is
contracted pairwise in a fixed order: first C.B^T per chunk and head,
``(b, c, h, l, s)``, times the decay ``L``, then that against x.  The
largest intermediates are (B, nc, H, chunk, chunk) float32 tensors (0.94
GB each at zamba2's 2 x 8192 tokens, 112 heads, chunk 128); an order that
contracted ``L`` with x first would hold (B, nc, H, chunk, chunk, P).

Both gates (the conv output's SiLU and the output gate) go through
:func:`repro_torch.lm.layers.gated_silu`: on the card a ``pwl4`` gate is
one ``silu_pwl4`` launch of ``pwl_activation`` each; ``fused=False`` (the
training route) keeps them op by op, since the kernel has no backward.
``in_proj`` and ``out_proj`` are read through :func:`wval`, so a quantized
artifact's ``w_q`` is dequantized at use, as the reference's ``wval``.

Decode carries ``(conv, ssm)``, constant in the sequence length; the step
updates both buffers in place, as the KV path does.

**On a mesh** (``rules``; x a DTensor, its batch on the data axes) the
projections are DTensor products, and everything between them runs in
one ``local_map`` a layer on each rank's batch rows (:func:`_scan`,
:func:`_step`): the heads on ``model`` where the rules shard both the
SSM head count and ``n_groups`` (a rank's heads then read only its
groups), else replicated.  ``param_specs`` shards ``in_proj``'s
``z | xBC | dt`` columns, and ``conv_w``'s ``x | B | C`` channels,
contiguously on ``model``, which cuts inside ``xBC``: the projection is
gathered whole over ``model``, and each rank takes its heads' and groups'
columns of each block (:func:`_share`); the leaves are gathered likewise.
A value a rank reads only in part has a gradient that is a partial sum
over the ranks that split it (``local_map``'s ``in_grad_placements``).
The gated RMSNorm over all of ``d_in`` then runs on the head-sharded
DTensor, its mean of squares a sum over ``model`` ranks.  The conv state
keeps every channel on each rank; the SSM state, the rank's heads.
"""

from __future__ import annotations

import math
from typing import TYPE_CHECKING, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import SSMConfig
from repro_torch.sharding.rules import shard
from repro_torch.spans import span

from .layers import (activation_fn, draw_device, gated_silu, init_linear,
                     local_heads, rmsnorm, wval)

if TYPE_CHECKING:
    from repro_torch.sharding.rules import Rules

__all__ = ["mamba2_params", "mamba2_forward", "mamba2_decode",
           "init_mamba_cache", "ssd_scan", "FLOAT32_LEAVES"]

# leaves the reference keeps in float32 whatever the model's dtype
FLOAT32_LEAVES = ("A_log", "dt_bias", "D")


def _dims(d_model: int, s: SSMConfig) -> Tuple[int, int, int]:
    d_in = s.expand * d_model
    n_heads = d_in // s.head_dim
    conv_dim = d_in + 2 * s.n_groups * s.d_state
    return d_in, n_heads, conv_dim


def mamba2_params(generator: torch.Generator, d_model: int, s: SSMConfig,
                  dtype: torch.dtype, lead=()) -> Dict:
    """One Mamba2 layer's parameters (the reference's leaves, init scales
    and dtypes), with leading (stacked) dims, on the generator's device."""
    d_in, n_heads, conv_dim = _dims(d_model, s)
    dev, lead = draw_device(generator), tuple(lead)
    d_proj = 2 * d_in + 2 * s.n_groups * s.d_state + n_heads
    a_log = torch.log(torch.linspace(1.0, 16.0, n_heads, dtype=torch.float32,
                                     device=dev))
    conv_w = torch.randn(lead + (s.d_conv, conv_dim), generator=generator,
                         dtype=torch.float32, device=dev)
    return {
        "in_proj": init_linear(generator, d_model, d_proj, dtype, lead=lead),
        "conv_w": conv_w.mul_(1.0 / math.sqrt(s.d_conv)).to(dtype),
        "conv_b": torch.zeros(lead + (conv_dim,), dtype=dtype, device=dev),
        "A_log": a_log.expand(lead + (n_heads,)).clone(),
        "dt_bias": torch.zeros(lead + (n_heads,), dtype=torch.float32,
                               device=dev),
        "D": torch.ones(lead + (n_heads,), dtype=torch.float32, device=dev),
        "norm_scale": torch.zeros(lead + (d_in,), dtype=dtype, device=dev),
        "out_proj": init_linear(generator, d_in, d_model, dtype, lead=lead),
    }


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """x: (..., T) -> (..., T, T) lower-triangular segment sums, -inf above
    the diagonal."""
    t = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((t, t), dtype=torch.bool, device=x.device))
    return diff.masked_fill(~mask, -math.inf)


def _ssd_chunked(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                 c: torch.Tensor, chunk: int) -> torch.Tensor:
    """The SSD scan.  x: (B, L, H, P); a: (B, L, H) (= dt * A, negative);
    b, c: (B, L, H, N) (groups expanded to heads); ``chunk`` divides L.
    Returns (B, L, H, P) float32."""
    return _ssd_chunks(x, a, b, c, chunk)[0]


def _ssd_chunks(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                c: torch.Tensor, chunk: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`_ssd_chunked`'s y and the state after the last position
    (B, H, P, N) float32."""
    bsz, length, h, p = x.shape
    n = b.shape[-1]
    nc = length // chunk
    xs = x.reshape(bsz, nc, chunk, h, p)
    bs = b.reshape(bsz, nc, chunk, h, n)
    cs = c.reshape(bsz, nc, chunk, h, n)
    av = a.reshape(bsz, nc, chunk, h).permute(0, 3, 1, 2)  # (B, H, nc, l)
    a_cumsum = torch.cumsum(av, dim=-1)

    # intra-chunk (diagonal blocks): (C . B^T) * L, then against x
    scores = torch.einsum("bclhn,bcshn->bchls", cs, bs)
    scores = scores * torch.exp(_segsum(av)).permute(0, 2, 1, 3, 4)
    y_diag = torch.einsum("bchls,bcshp->bclhp", scores, xs)
    del scores

    # chunk-final states
    decay_states = torch.exp(a_cumsum[..., -1:] - a_cumsum)  # (B, H, nc, l)
    states = torch.einsum("bcshn,bcshp->bchpn",
                          bs * decay_states.permute(0, 2, 3, 1)[..., None],
                          xs)

    # inter-chunk recurrence through the (nc + 1) x (nc + 1) decay matrix
    padded = F.pad(a_cumsum[..., -1], (1, 0))  # (B, H, nc + 1)
    decay_chunk = torch.exp(_segsum(padded))  # (B, H, nc + 1, nc + 1)
    all_states = torch.cat([torch.zeros_like(states[:, :1]), states], dim=1)
    new_states = torch.einsum("bhzc,bchpn->bzhpn", decay_chunk, all_states)
    prev_states = new_states[:, :-1]  # the state entering each chunk

    # off-diagonal contribution
    state_decay_out = torch.exp(a_cumsum).permute(0, 2, 3, 1)  # (B,nc,l,H)
    y_off = torch.einsum("bclhn,bchpn->bclhp", cs, prev_states)
    y = y_diag + y_off * state_decay_out[..., None]
    return y.reshape(bsz, length, h, p), new_states[:, -1]


def ssd_scan(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
             c: torch.Tensor, chunk: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`_ssd_chunks` at any L: one chunk of L where L <= ``chunk``;
    else x and a padded with zeros after the last position up to a multiple
    of ``chunk`` (a = dt * A = 0 keeps the carried state as it is, x = 0
    adds nothing to it: the final state is the last real position's), and
    y sliced back.  The padded positions are counted in
    ``ssd_scan.padded_positions`` (a sum over the batch's rows)."""
    bsz, length = x.shape[:2]
    if length <= chunk:
        return _ssd_chunks(x, a, b, c, length)
    pad = -length % chunk
    if not pad:
        return _ssd_chunks(x, a, b, c, chunk)
    ssd_scan.padded_positions += bsz * pad
    x, b, c = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (x, b, c))
    y, final = _ssd_chunks(x, F.pad(a, (0, 0, 0, pad)), b, c, chunk)
    return y[:, :length], final


ssd_scan.padded_positions = 0


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 bias: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv.  x: (B, L, C); w: (K, C); the K taps summed
    in order, in x's dtype, as the reference sums them."""
    k = w.shape[0]
    pad = F.pad(x, (0, 0, k - 1, 0))
    out = pad[:, 0:x.shape[1], :] * w[0]
    for i in range(1, k):
        out = out + pad[:, i:i + x.shape[1], :] * w[i]
    return out + bias


def _split_proj(proj: torch.Tensor, d_in: int, s: SSMConfig):
    gn = s.n_groups * s.d_state
    z = proj[..., :d_in]
    xbc = proj[..., d_in:d_in + d_in + 2 * gn]
    dt = proj[..., d_in + d_in + 2 * gn:]
    return z, xbc, dt


def _expand_groups(t: torch.Tensor, n_heads: int,
                   n_groups: int) -> torch.Tensor:
    """(B, ..., G, N) -> (B, ..., H, N), each group repeated H / G times."""
    return torch.repeat_interleave(t, n_heads // n_groups, dim=-2)


def _heads_axis(rules: "Rules", n_heads: int, s: SSMConfig):
    """``'model'`` where the rules shard both the SSM head count and
    ``n_groups`` on it (a rank's heads then read only its groups), else
    None (the heads replicated)."""
    both = (rules.resolve("model", n_heads) is not None
            and rules.resolve("model", s.n_groups) is not None)
    return "model" if both else None


def _share(t: torch.Tensor, sizes, part: int, parts: int) -> torch.Tensor:
    """``t``'s last dim, laid out as consecutive blocks of ``sizes``: the
    ``part``-th of ``parts`` equal pieces of each block, joined (``t``
    itself for one part).  A rank's heads of ``z`` or ``dt``, its heads
    and groups of the conv's ``x | B | C`` channels."""
    if parts == 1:
        return t
    pieces, start = [], 0
    for n in sizes:
        w = n // parts
        pieces.append(t.narrow(-1, start + part * w, w))
        start += n
    return pieces[0] if len(pieces) == 1 else torch.cat(pieces, -1)


def _scan(part: int, parts: int, proj: torch.Tensor, conv_w, conv_b,
          dt_bias, a_log, d_skip, d_in: int, n_heads: int, s: SSMConfig,
          gate, state: Optional[Dict] = None) -> torch.Tensor:
    """The layer between its projections, on ``part`` of ``parts`` of the
    heads (all of them for one part): the conv, the SSD scan and the
    output gate.  proj: (B, L, d_proj), whole; the leaves whole.  Returns
    ``y * gate(z)`` (B, L, d_in / parts) in proj's dtype.  ``state`` (one
    part only): a decode cache's ``conv`` and ``ssm`` buffers, written with
    the state after the last position."""
    gn = s.n_groups * s.d_state
    h, g, di = n_heads // parts, s.n_groups // parts, d_in // parts
    channels = (d_in, gn, gn)
    z, xbc, dt = (_share(t, n, part, parts) for t, n in
                  zip(_split_proj(proj, d_in, s), ((d_in,), channels,
                                                   (n_heads,))))
    conv_w, conv_b = (_share(t, channels, part, parts)
                      for t in (conv_w, conv_b))
    dt_bias, a_log, d_skip = (_share(t, (n_heads,), part, parts)
                              for t in (dt_bias, a_log, d_skip))
    bsz, length, _ = proj.shape
    if state is not None:  # the conv's last d_conv - 1 inputs
        hist = F.pad(xbc, (0, 0, max(0, s.d_conv - 1 - length), 0))
        state["conv"].copy_(hist[:, hist.shape[1] - (s.d_conv - 1):])
    xbc = gate(_causal_conv(xbc, conv_w, conv_b))
    xi = xbc[..., :di]
    bmat = xbc[..., di:di + g * s.d_state].reshape(bsz, length, g, s.d_state)
    cmat = xbc[..., di + g * s.d_state:].reshape(bsz, length, g, s.d_state)

    dt = F.softplus(dt.to(torch.float32) + dt_bias)  # (B, L, h)
    a = -torch.exp(a_log)  # (h,)
    xh = xi.reshape(bsz, length, h, s.head_dim).to(torch.float32)
    bh = _expand_groups(bmat, h, g).to(torch.float32)
    ch = _expand_groups(cmat, h, g).to(torch.float32)

    with span("lm.ssd"):
        y, final = ssd_scan(xh * dt[..., None], dt * a, bh, ch, s.chunk)
    if state is not None:
        state["ssm"].copy_(final)
    y = y + d_skip[:, None] * xh
    y = y.reshape(bsz, length, di).to(proj.dtype)
    return y * gate(z)


def _leaves(p: Dict):
    return (p["conv_w"], p["conv_b"], p["dt_bias"], p["A_log"], p["D"])


def _heads_placed(x, dim: int, heads):
    """``x``'s placements with ``dim`` sharded on ``model`` where the heads
    are, else as they are (replicated there)."""
    from torch.distributed.tensor import Shard

    out = list(x.placements)
    if heads is not None:
        out[list(x.device_mesh.mesh_dim_names).index("model")] = Shard(dim)
    return out


def _gated_norm(y: torch.Tensor, scale: torch.Tensor, groups: int,
                eps: float) -> torch.Tensor:
    """RMSNorm of the gated ``y`` over each of ``groups`` equal slices of
    d_in (mamba_ssm's ``RMSNormGated(group_size=d_in / ngroups)``); one
    group is the whole of d_in."""
    if groups == 1:
        return rmsnorm(y, scale, eps)
    shape = y.shape
    yg = y.reshape(shape[:-1] + (groups, shape[-1] // groups))
    return rmsnorm(yg, scale.reshape(groups, -1), eps).reshape(shape)


def mamba2_forward(p: Dict, x: torch.Tensor, d_model: int, s: SSMConfig,
                   gate_sigmoid: str = "exact", fused: bool = True,
                   rules: "Optional[Rules]" = None, norm_groups: int = 1,
                   eps: float = 1e-6,
                   state: Optional[Dict] = None) -> torch.Tensor:
    """Full-sequence forward.  x: (B, L, d) -> (B, L, d), any L
    (:func:`ssd_scan` pads the scan to a multiple of the chunk).  The gated
    norm runs over ``norm_groups`` slices of d_in with ``eps``.  ``state``:
    a decode cache's ``conv`` and ``ssm`` buffers for this layer, written
    with the state after the last position (prefill; not under rules).
    Under ``rules`` (x a DTensor, its batch on the data axes) the conv, the
    scan and the gate run in one ``local_map`` on each rank's batch rows and
    heads (the module docstring)."""
    with span("lm.mamba"):
        d_in, n_heads, _ = _dims(d_model, s)
        proj = x @ wval(p["in_proj"], x.dtype)
        gate = activation_fn("silu", gate_sigmoid, fused)

        def scan(part, parts, proj, *leaves):
            return _scan(part, parts, proj, *leaves, d_in, n_heads, s, gate,
                         state)

        if rules is None:
            y = scan(0, 1, proj, *_leaves(p))
        else:
            heads = _heads_axis(rules, n_heads, s)
            # whole columns: a shard of z | xBC | dt is not head-aligned
            proj = shard(proj, ("batch", None, None), rules)
            y = local_heads(scan, [_heads_placed(proj, 2, heads)], [proj],
                            _leaves(p), heads is not None, whole=(0,))
        y = _gated_norm(y, p["norm_scale"], norm_groups, eps)
        return y @ wval(p["out_proj"], y.dtype)


def init_mamba_cache(batch: int, d_model: int, s: SSMConfig,
                     dtype: torch.dtype, device: torch.device,
                     lead=()) -> Dict:
    """The decode state, with leading (stacked) dims: the conv's last
    ``d_conv - 1`` inputs in the model dtype, the SSM state in float32."""
    d_in, n_heads, conv_dim = _dims(d_model, s)
    lead = tuple(lead)
    return {
        "conv": torch.zeros(lead + (batch, s.d_conv - 1, conv_dim),
                            dtype=dtype, device=device),
        "ssm": torch.zeros(lead + (batch, n_heads, s.head_dim, s.d_state),
                           dtype=torch.float32, device=device),
    }


def _step(part: int, parts: int, proj: torch.Tensor, conv: torch.Tensor,
          ssm: torch.Tensor, conv_w, conv_b, dt_bias, a_log, d_skip,
          d_in: int, n_heads: int, s: SSMConfig, gate_sigmoid: str):
    """One decode step between the projections, on ``part`` of ``parts``
    of the heads: proj (B, d_proj) whole, ``conv`` (B, K-1, C) whole and
    ``ssm`` (B, H / parts, P, N) this part's, both updated in place.
    Returns ``y * gate(z)`` (B, d_in / parts) and the two buffers."""
    gn = s.n_groups * s.d_state
    h, g, di = n_heads // parts, s.n_groups // parts, d_in // parts
    channels = (d_in, gn, gn)
    bsz = proj.shape[0]
    z, xbc, dt = _split_proj(proj, d_in, s)
    z = _share(z, (d_in,), part, parts)
    dt = _share(dt, (n_heads,), part, parts)

    # the conv over the (B, K-1, C) history and the current input; the
    # history keeps every channel, the conv reads this part's
    hist = torch.cat([conv, xbc[:, None, :]], dim=1)  # (B, K, C)
    conv_out = torch.einsum(
        "bkc,kc->bc", _share(hist, channels, part, parts).to(torch.float32),
        _share(conv_w, channels, part, parts).to(torch.float32)) + _share(
            conv_b, channels, part, parts)
    xbc_t = gated_silu(conv_out.to(proj.dtype), gate_sigmoid)
    conv.copy_(hist[:, 1:])

    xi = xbc_t[..., :di]
    bmat = xbc_t[..., di:di + g * s.d_state].reshape(bsz, g, s.d_state)
    cmat = xbc_t[..., di + g * s.d_state:].reshape(bsz, g, s.d_state)

    dt_bias, a_log, d_skip = (_share(t, (n_heads,), part, parts)
                              for t in (dt_bias, a_log, d_skip))
    dt = F.softplus(dt.to(torch.float32) + dt_bias)  # (B, h)
    a = -torch.exp(a_log)
    da = torch.exp(dt * a)  # (B, h)
    xh = xi.reshape(bsz, h, s.head_dim).to(torch.float32)
    bh = _expand_groups(bmat, h, g).to(torch.float32)
    ch = _expand_groups(cmat, h, g).to(torch.float32)

    ssm.mul_(da[..., None, None]).add_(
        (xh * dt[..., None])[..., :, None] * bh[..., None, :])
    y = torch.einsum("bhpn,bhn->bhp", ssm, ch) + d_skip[:, None] * xh
    y = y.reshape(bsz, di).to(proj.dtype)
    return y * gated_silu(z, gate_sigmoid), conv, ssm


def mamba2_decode(p: Dict, x: torch.Tensor, cache: Dict, d_model: int,
                  s: SSMConfig, gate_sigmoid: str = "exact",
                  rules: "Optional[Rules]" = None, norm_groups: int = 1,
                  eps: float = 1e-6) -> Tuple[torch.Tensor, Dict]:
    """One-token recurrent step.  x: (B, 1, d) -> (B, 1, d); ``cache``'s
    ``conv`` and ``ssm`` buffers are updated in place and returned.  Under
    ``rules`` the step runs on each rank's batch rows and heads through one
    ``local_map``: on the cache's local shards where it is placed as the
    step reads it (the batch on the data axes, the conv's channels whole,
    the SSM state's heads on ``model`` with the rank's heads), else on a
    copy placed so, written back into the cache.  ``norm_groups`` and
    ``eps``: the gated norm's, as in :func:`mamba2_forward`."""
    d_in, n_heads, _ = _dims(d_model, s)
    proj = x[:, 0] @ wval(p["in_proj"], x.dtype)  # (B, d_proj)

    def step(part, parts, proj, conv, ssm, *leaves):
        return _step(part, parts, proj, conv, ssm, *leaves, d_in, n_heads, s,
                     gate_sigmoid)

    if rules is None:
        y, _, _ = step(0, 1, proj, cache["conv"], cache["ssm"], *_leaves(p))
    else:
        heads = _heads_axis(rules, n_heads, s)
        proj = shard(proj, ("batch", None), rules)
        conv = shard(cache["conv"], ("batch", None, None), rules)
        ssm = shard(cache["ssm"], ("batch", heads, None, None), rules)
        y, conv, ssm = local_heads(
            step, (_heads_placed(proj, 1, heads), conv.placements,
                   ssm.placements), [proj, conv, ssm], _leaves(p),
            heads is not None, whole=(0, 1))
        for k, v in (("conv", conv), ("ssm", ssm)):
            # the step wrote the cache's own buffer where the cache was
            # placed as the step reads it; else a copy, written back here
            if v.to_local().data_ptr() != cache[k].to_local().data_ptr():
                cache[k].copy_(v.redistribute(v.device_mesh,
                                              cache[k].placements))
    y = _gated_norm(y, p["norm_scale"], norm_groups, eps)
    out = (y @ wval(p["out_proj"], y.dtype))[:, None, :]
    return out, cache
