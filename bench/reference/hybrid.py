"""Zamba2's published hybrid (81 Mamba2 layers, two shared transformer
blocks at 13 calls), in plain PyTorch.

What it computes, from the parameter tree the port's
``repro_torch.lm.model.forward`` takes (``block_pattern "zamba2"``) and
the configuration file's keys (HF's ``Zamba2Config``): token embedding
``emb``; per layer i, where i is in ``hybrid_layer_ids`` (the c-th such
layer), the shared block ``c % num_mem_blocks`` on ``concat(x, emb)``:
RMSNorm ``x / rms(x) * (1 + scale)``, attention of
``num_attention_heads`` heads of ``attention_head_dim`` with RoPE on
interleaved pairs and scores times ``(dh / 2)^-1/2`` (HF's
``Zamba2Attention.scaling``), RMSNorm, the GLU MLP ``wo(gelu(x wg +
x wa ag) * (x wi + x wa ai))`` with exact GELU and call c's adapter
``(wa, ag, ai)``, then call c's linear: ``t``; else ``t = 0``.  Then the
Mamba2 mixer on ``norm(x + t)``: ``z | xBC | dt`` from ``in_proj``, the
depthwise causal conv of ``d_conv`` taps on xBC and SiLU, ``dt =
softplus(dt + dt_bias)``, ``A = -exp(A_log)``, the SSD in its quadratic
dual form ``y = (L o C B^T) (x dt) + D x`` with ``L[i, j] = exp(sum_{j <
t <= i} dt_t A)`` (C B^T once a group, L a head), the gate ``y silu(z)``
RMS-normalised over each of ``mamba_ngroups`` groups, ``out_proj``; ``x
<- x + mixer``.  The final norm and the tied head at the ``rows`` asked
for.

Independent of the port's chunking and padding: no chunks, any length.
Float32 with TF32 off (the segment sums of ``dt A`` in float64, whose
cumulative sums over 4096 positions float32 would round), one layer at a
time with its weights widened at use, attention in blocks of query rows
and the SSD in blocks of heads, so the full model fits beside the
program's weights.

``precision="fp8"`` is the control: every product's operands (the
linears' inputs and weights, attention's q, k and v, the SSD's C, B, x dt
and ``L o C B^T``) rounded to float8 e4m3 with one scale a tensor.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from .dense import _Math, _no_tf32, _rms, _rope

__all__ = ["forward_rows"]

# attention's float32 score block and the SSD's head block: at most this
# many elements at once
_SCORE_BLOCK = 2**29


def _at(tree: Dict, i: int) -> Dict:
    return {k: _at(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def _group_rms(x: torch.Tensor, scale: torch.Tensor, groups: int,
               eps: float) -> torch.Tensor:
    s, d = x.shape
    y = _rms(x.reshape(s, groups, d // groups),
             scale.reshape(groups, d // groups), eps)
    return y.reshape(s, d)


def _attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               scale: float) -> torch.Tensor:
    """Causal softmax attention, q (S, H, dh), k, v (S, Hkv, dh), in blocks
    of query rows against the keys each can see."""
    s, h, _ = q.shape
    group = h // k.shape[1]
    k = k.repeat_interleave(group, dim=1)
    v = v.repeat_interleave(group, dim=1)
    rows = max(1, min(s, _SCORE_BLOCK // max(1, h * s)))
    out = torch.empty_like(q)
    for i0 in range(0, s, rows):
        i1 = min(s, i0 + rows)
        qp = torch.arange(i0, i1, device=q.device)[:, None]
        kp = torch.arange(0, i1, device=q.device)[None, :]
        scores = torch.einsum("qhd,khd->hqk", q[i0:i1], k[:i1]) * scale
        scores = scores.masked_fill(kp > qp, -math.inf)
        out[i0:i1] = torch.einsum("hqk,khd->qhd", torch.softmax(scores, -1),
                                  v[:i1])
    return out


def _shared(cfg: Dict, m: _Math, block: Dict, call: Dict, x: torch.Tensor,
            emb: torch.Tensor, eps: float) -> torch.Tensor:
    s = x.shape[0]
    h, hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    dh = cfg["attention_head_dim"]
    theta = float(cfg["rope_theta"])
    at, mlp, ad = block["attn"], block["mlp"], call["adapter"]
    z = _rms(torch.cat([x, emb], -1), block["ln_in"]["scale"], eps)
    q = m.mm(z, at["wq"]["w"]).reshape(s, h, dh)
    k = m.mm(z, at["wk"]["w"]).reshape(s, hkv, dh)
    v = m.mm(z, at["wv"]["w"]).reshape(s, hkv, dh)
    del z
    o = _attention(m.q(_rope(q, theta)), m.q(_rope(k, theta)), m.q(v),
                   (dh / 2) ** -0.5)
    a = _rms(m.mm(o.reshape(s, h * dh), at["wo"]["w"]),
             block["ln_ff"]["scale"], eps)
    del q, k, v, o
    low = m.mm(a, ad["wa"]["w"])
    g = m.mm(a, mlp["wg"]["w"]) + m.mm(low, ad["wg"]["w"])
    u = m.mm(a, mlp["wi"]["w"]) + m.mm(low, ad["wi"]["w"])
    return m.mm(m.mm(F.gelu(g) * u, mlp["wo"]["w"]), call["linear"]["w"])


def _ssd(m: _Math, x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
         b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """The SSD's quadratic form.  x (S, H, P), dt (S, H), a (H,) = A,
    b and c (S, G, N).  Returns (S, H, P)."""
    s, h, _ = x.shape
    groups = b.shape[1]
    per_group = h // groups
    below = torch.tril(torch.ones(s, s, dtype=torch.bool, device=x.device))
    block = max(1, min(per_group, _SCORE_BLOCK // (2 * s * s)))
    y = torch.empty_like(x)
    for g in range(groups):
        cb = m.q(c[:, g]) @ m.q(b[:, g]).T  # (S_i, S_j)
        for h0 in range(g * per_group, (g + 1) * per_group, block):
            h1 = min(h0 + block, (g + 1) * per_group)
            cs = torch.cumsum((dt[:, h0:h1] * a[h0:h1]).double(), 0)
            seg = (cs.T[:, :, None] - cs.T[:, None, :]).masked_fill_(
                ~below, -math.inf)  # (hb, S_i, S_j)
            mat = torch.exp(seg).to(x.dtype).mul_(cb)
            del seg
            u = x[:, h0:h1] * dt[:, h0:h1, None]  # (S, hb, P)
            y[:, h0:h1] = torch.einsum("hij,jhp->ihp", m.q(mat), m.q(u))
            del mat
    return y


def _mamba(cfg: Dict, m: _Math, p: Dict, x: torch.Tensor,
           eps: float) -> torch.Tensor:
    s = x.shape[0]
    d_in = cfg["mamba_expand"] * cfg["hidden_size"]
    heads, hd = cfg["n_mamba_heads"], cfg["mamba_headdim"]
    groups, n = cfg["mamba_ngroups"], cfg["mamba_d_state"]
    proj = m.mm(x, p["in_proj"]["w"])
    zg = proj[:, :d_in]
    xbc = proj[:, d_in:2 * d_in + 2 * groups * n]
    dt = proj[:, 2 * d_in + 2 * groups * n:]
    w = p["conv_w"].to(x.dtype)  # (K, C)
    taps = w.shape[0]
    hist = F.pad(xbc, (0, 0, taps - 1, 0))
    conv = sum(hist[i:i + s] * w[i] for i in range(taps))
    xbc = F.silu(conv + p["conv_b"].to(x.dtype))
    xs = xbc[:, :d_in].reshape(s, heads, hd)
    bm = xbc[:, d_in:d_in + groups * n].reshape(s, groups, n)
    cm = xbc[:, d_in + groups * n:].reshape(s, groups, n)
    dt = F.softplus(dt + p["dt_bias"].to(x.dtype))
    a = -torch.exp(p["A_log"].to(x.dtype))
    y = _ssd(m, xs, dt, a, bm, cm) + p["D"].to(x.dtype)[:, None] * xs
    y = y.reshape(s, d_in) * F.silu(zg)
    y = _group_rms(y, p["norm_scale"], groups, eps)
    return m.mm(y, p["out_proj"]["w"])


def forward_rows(cfg: Dict, params: Dict, tokens: torch.Tensor,
                 image: Optional[torch.Tensor], rows: torch.Tensor,
                 precision: str = "float32") -> torch.Tensor:
    """Logits (len(rows), vocab) at positions ``rows`` of one sequence of
    ``tokens`` (T,) (``image`` must be None: the model reads text only).
    float32, or float64 for float64 weights; ``precision="fp8"`` is the
    control."""
    if image is not None and image.shape[0]:
        raise ValueError("Zamba2 reads text only")
    table = params["embed"]["table"]
    dtype = torch.promote_types(table.dtype, torch.float32)
    m = _Math(precision, dtype)
    eps = float(cfg["rms_norm_eps"])
    hybrid = list(cfg["hybrid_layer_ids"])
    layers = params["layers"]
    with torch.no_grad(), _no_tf32():
        x = table[tokens.long()].to(dtype)
        emb = x
        for i in range(cfg["num_hidden_layers"]):
            p = _at(layers, i)
            h = x
            if i in hybrid:
                c = hybrid.index(i)
                t = _shared(cfg, m, _at(params["shared"],
                                        c % cfg["num_mem_blocks"]),
                            _at(params["hybrid"], c), x, emb, eps)
                h = x + t
                del t
            x = x + _mamba(cfg, m, p["mamba"], _rms(h, p["ln"]["scale"], eps),
                           eps)
            del h
        x = _rms(x[rows.long()], params["final_norm"]["scale"], eps)
        return m.mm(x, table.T)
