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
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import SSMConfig

from .layers import (activation_fn, draw_device, gated_silu, init_linear,
                     rmsnorm, wval)

__all__ = ["mamba2_params", "mamba2_forward", "mamba2_decode",
           "init_mamba_cache", "FLOAT32_LEAVES"]

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
    return y.reshape(bsz, length, h, p)


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


def mamba2_forward(p: Dict, x: torch.Tensor, d_model: int, s: SSMConfig,
                   gate_sigmoid: str = "exact",
                   fused: bool = True) -> torch.Tensor:
    """Full-sequence forward.  x: (B, L, d) -> (B, L, d); L a multiple of
    ``min(s.chunk, L)``, as the reference's reshape requires."""
    d_in, n_heads, _ = _dims(d_model, s)
    bsz, length, _ = x.shape
    proj = x @ wval(p["in_proj"], x.dtype)
    z, xbc, dt = _split_proj(proj, d_in, s)
    gate = activation_fn("silu", gate_sigmoid, fused)
    xbc = gate(_causal_conv(xbc, p["conv_w"], p["conv_b"]))
    gn = s.n_groups * s.d_state
    xi = xbc[..., :d_in]
    bmat = xbc[..., d_in:d_in + gn].reshape(bsz, length, s.n_groups,
                                            s.d_state)
    cmat = xbc[..., d_in + gn:].reshape(bsz, length, s.n_groups, s.d_state)

    dt = F.softplus(dt.to(torch.float32) + p["dt_bias"])  # (B, L, H)
    a = -torch.exp(p["A_log"])  # (H,)
    xh = xi.reshape(bsz, length, n_heads, s.head_dim).to(torch.float32)
    bh = _expand_groups(bmat, n_heads, s.n_groups).to(torch.float32)
    ch = _expand_groups(cmat, n_heads, s.n_groups).to(torch.float32)

    y = _ssd_chunked(xh * dt[..., None], dt * a, bh, ch, min(s.chunk, length))
    y = y + p["D"][:, None] * xh
    y = y.reshape(bsz, length, d_in).to(x.dtype)
    y = rmsnorm(y * gate(z), p["norm_scale"])
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


def mamba2_decode(p: Dict, x: torch.Tensor, cache: Dict, d_model: int,
                  s: SSMConfig,
                  gate_sigmoid: str = "exact") -> Tuple[torch.Tensor, Dict]:
    """One-token recurrent step.  x: (B, 1, d) -> (B, 1, d); ``cache``'s
    ``conv`` and ``ssm`` buffers are updated in place and returned."""
    d_in, n_heads, _ = _dims(d_model, s)
    bsz = x.shape[0]
    proj = x[:, 0] @ wval(p["in_proj"], x.dtype)  # (B, d_proj)
    z, xbc, dt = _split_proj(proj, d_in, s)

    # the conv over the (B, K-1, C) history and the current input
    hist = torch.cat([cache["conv"], xbc[:, None, :]], dim=1)  # (B, K, C)
    conv_out = torch.einsum("bkc,kc->bc", hist.to(torch.float32),
                            p["conv_w"].to(torch.float32)) + p["conv_b"]
    xbc_t = gated_silu(conv_out.to(x.dtype), gate_sigmoid)
    cache["conv"].copy_(hist[:, 1:])

    gn = s.n_groups * s.d_state
    xi = xbc_t[..., :d_in]
    bmat = xbc_t[..., d_in:d_in + gn].reshape(bsz, s.n_groups, s.d_state)
    cmat = xbc_t[..., d_in + gn:].reshape(bsz, s.n_groups, s.d_state)

    dt = F.softplus(dt.to(torch.float32) + p["dt_bias"])  # (B, H)
    a = -torch.exp(p["A_log"])
    da = torch.exp(dt * a)  # (B, H)
    xh = xi.reshape(bsz, n_heads, s.head_dim).to(torch.float32)
    bh = _expand_groups(bmat, n_heads, s.n_groups).to(torch.float32)
    ch = _expand_groups(cmat, n_heads, s.n_groups).to(torch.float32)

    state = cache["ssm"]
    state.mul_(da[..., None, None]).add_(
        (xh * dt[..., None])[..., :, None] * bh[..., None, :])
    y = torch.einsum("bhpn,bhn->bhp", state, ch) + p["D"][:, None] * xh
    y = y.reshape(bsz, d_in).to(x.dtype)
    y = rmsnorm(y * gated_silu(z, gate_sigmoid), p["norm_scale"])
    out = (y @ wval(p["out_proj"], y.dtype))[:, None, :]
    return out, cache
