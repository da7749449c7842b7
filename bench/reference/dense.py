"""The decoder stack with a prepended image projection, in plain PyTorch.

A frozen copy of the function the port's plain route computes
(``repro_torch.lm.model.forward`` with ``attn_impl="ref"``): token
embedding, the image activations through one linear and prepended; per
layer RMSNorm ``x / rms(x) * (1 + scale)``, grouped-query causal attention
with RoPE on interleaved pairs, the SwiGLU MLP; the final norm and the
head.  Everything runs in float32 (or float64 where the weights are), one
layer at a time with that layer's weights widened at use, and attention in
blocks of query rows, so the full-size model fits beside the program's
weights.  Only the ``rows`` asked for go through the head.

``precision="fp8"`` is the control: every matrix product's two operands
(the linears' inputs and weights, attention's q, k and v) are rounded to
float8 e4m3 with one scale per tensor (its largest magnitude to 448), the
step below bfloat16 that a later change might take.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Iterator, Optional

import torch

__all__ = ["forward_rows", "PRECISIONS"]

PRECISIONS = ("float32", "fp8")
_FP8_MAX = 448.0
# attention's float32 score block: at most this many elements at once
_SCORE_BLOCK = 2**29


@contextlib.contextmanager
def _no_tf32() -> Iterator[None]:
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old[0]
        torch.backends.cudnn.allow_tf32 = old[1]
        torch.set_float32_matmul_precision(old[2])


def _fp8(t: torch.Tensor) -> torch.Tensor:
    scale = t.abs().amax().clamp_min(1e-30) / _FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale


class _Math:
    def __init__(self, precision: str, dtype: torch.dtype):
        if precision not in PRECISIONS:
            raise ValueError(f"precision must be one of {PRECISIONS}")
        self.fp8 = precision == "fp8"
        self.dtype = dtype

    def w(self, t: torch.Tensor) -> torch.Tensor:
        return t.to(self.dtype)

    def q(self, t: torch.Tensor) -> torch.Tensor:
        return _fp8(t) if self.fp8 else t

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return self.q(x) @ self.q(self.w(w))


def _rms(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    return x * torch.rsqrt(var + eps) * (1.0 + scale.to(x.dtype))


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (S, H, dh), rotated pairwise (0::2 with 1::2) at positions
    0..S-1; the angles in float32."""
    s, _, dh = x.shape
    exps = torch.arange(0, dh, 2, dtype=torch.float32, device=x.device) / dh
    freqs = 1.0 / torch.pow(theta, exps)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * freqs
    cos = torch.cos(ang).to(x.dtype)[:, None, :]
    sin = torch.sin(ang).to(x.dtype)[:, None, :]
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                       dim=-1).reshape(x.shape)


def _attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               window: Optional[int]) -> torch.Tensor:
    """Causal softmax attention, q (S, H, dh), k and v (S, Hkv, dh) with H /
    Hkv query heads a KV head; keys at ``q - k >= window`` masked.  Blocks
    of query rows, each against the keys it can see."""
    s, h, dh = q.shape
    group = h // k.shape[1]
    k = k.repeat_interleave(group, dim=1)
    v = v.repeat_interleave(group, dim=1)
    scale = 1.0 / math.sqrt(dh)
    rows = max(1, min(s, _SCORE_BLOCK // max(1, h * s)))
    out = torch.empty_like(q)
    for i0 in range(0, s, rows):
        i1 = min(s, i0 + rows)
        k0 = 0 if window is None else max(0, i0 - window + 1)
        qp = torch.arange(i0, i1, device=q.device)[:, None]
        kp = torch.arange(k0, i1, device=q.device)[None, :]
        keep = kp <= qp
        if window is not None:
            keep &= (qp - kp) < window
        scores = torch.einsum("qhd,khd->hqk", q[i0:i1], k[k0:i1]) * scale
        scores = scores.masked_fill(~keep, -math.inf)
        p = torch.softmax(scores, dim=-1)
        out[i0:i1] = torch.einsum("hqk,khd->qhd", p, v[k0:i1])
    return out


def forward_rows(cfg: Dict, params: Dict, tokens: torch.Tensor,
                 image: Optional[torch.Tensor], rows: torch.Tensor,
                 precision: str = "float32") -> torch.Tensor:
    """Logits (len(rows), vocab) at positions ``rows`` of one sequence:
    ``image`` (N, d) activations (or None) then ``tokens`` (T,).  float32,
    or float64 for float64 weights; ``precision="fp8"`` is the control."""
    table = params["embed"]["table"]
    dtype = torch.promote_types(table.dtype, torch.float32)
    m = _Math(precision, dtype)
    eps = float(cfg["rms_norm_eps"])
    theta = float(cfg["rope_theta"])
    h, hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    dh = cfg["head_dim"]
    window = cfg.get("sliding_window")
    layers = params["layers"]
    n_layers = layers["ln1"]["scale"].shape[0]
    with torch.no_grad(), _no_tf32():
        x = table[tokens.long()].to(dtype)
        if image is not None and image.shape[0]:
            img = m.mm(image.to(dtype), params["modality_proj"]["w"])
            x = torch.cat([img, x], dim=0)
        s = x.shape[0]
        for i in range(n_layers):
            at, mlp = layers["attn"], layers["mlp"]
            y = _rms(x, layers["ln1"]["scale"][i], eps)
            q = m.mm(y, at["wq"]["w"][i]).reshape(s, h, dh)
            k = m.mm(y, at["wk"]["w"][i]).reshape(s, hkv, dh)
            v = m.mm(y, at["wv"]["w"][i]).reshape(s, hkv, dh)
            o = _attention(m.q(_rope(q, theta)), m.q(_rope(k, theta)),
                           m.q(v), window)
            x = x + m.mm(o.reshape(s, h * dh), at["wo"]["w"][i])
            y = _rms(x, layers["ln2"]["scale"][i], eps)
            g = m.mm(y, mlp["wg"]["w"][i])
            u = m.mm(y, mlp["wi"]["w"][i])
            x = x + m.mm(g * torch.sigmoid(g) * u, mlp["wo"]["w"][i])
            del y, q, k, v, o, g, u
        x = _rms(x[rows.long()], params["final_norm"]["scale"], eps)
        head = (params["embed"]["table"].T if "head" not in params
                else params["head"]["w"])
        return m.mm(x, head)
