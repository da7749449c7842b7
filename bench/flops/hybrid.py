"""Counts for Zamba2's published hybrid (81 Mamba2 layers, shared
transformer blocks at ``hybrid_layer_ids``).

Per request of S = n_text tokens (no image), two operations a
multiply-add, d = hidden_size, f = intermediate_size, D = mamba_expand d,
G = mamba_ngroups, N = mamba_d_state, H_m = n_mamba_heads, P =
mamba_headdim, K = mamba_d_conv, H heads of dh at A = attention_hidden_size
(= H dh = 2 d), r = adapter_rank, V = vocab_size:

* per Mamba2 layer and position: ``in_proj`` 2 d (2 D + 2 G N + H_m), the
  depthwise conv 2 K (D + 2 G N), ``out_proj`` 2 D d;
* per Mamba2 layer, the SSD at ``chunk_size`` Q over chunks of lengths
  l_1..l_c (the last partial where Q does not divide S; the padding is
  not work): within each chunk C B^T over its causal pairs once a group,
  2 (l (l + 1) / 2) N G, and (L o C B^T) against x dt a head,
  2 (l (l + 1) / 2) P H_m; each chunk's final state 2 l N P H_m and each
  position's read of the state entering its chunk 2 l N P H_m; the state
  passed from chunk to chunk 2 N P H_m a chunk;
* per shared-block call (13) and position: q, k, v 2 A (3 H dh), o
  2 H dh d, the MLP's gate, up and down 2 (3 d f), the adapter 2 (d r +
  2 r f), the call's linear 2 d d;
* per call, attention's QK^T and PV over the causal pairs: 2 pairs H
  (dh + dh);
* the head: 2 S d V.

One ``flash_attention`` launch a call reads q, k and v once and writes o
once, in the model's dtype: (2 H + 2 Hkv) S dh elements.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from . import causal_pairs

__all__ = ["request_flops", "attention_calls"]

_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def _ssd_flops(cfg: Dict, s: int) -> float:
    q = cfg["chunk_size"]
    g, n = cfg["mamba_ngroups"], cfg["mamba_d_state"]
    h, p = cfg["n_mamba_heads"], cfg["mamba_headdim"]
    chunks = [min(q, s - i) for i in range(0, s, q)]
    pairs = sum(causal_pairs(length) for length in chunks)
    return float(2 * pairs * n * g + 2 * pairs * p * h
                 + 2 * 2 * s * n * p * h + 2 * len(chunks) * n * p * h)


def request_flops(cfg: Dict, n_image: int, n_text: int) -> float:
    """The forward's operations for one request."""
    s = n_image + n_text
    d, f, vocab = (cfg["hidden_size"], cfg["intermediate_size"],
                   cfg["vocab_size"])
    d_in = cfg["mamba_expand"] * d
    gn = cfg["mamba_ngroups"] * cfg["mamba_d_state"]
    mamba = (2 * d * (2 * d_in + 2 * gn + cfg["n_mamba_heads"])
             + 2 * cfg["mamba_d_conv"] * (d_in + 2 * gn) + 2 * d_in * d)
    a, h, hkv, dh = (cfg["attention_hidden_size"],
                     cfg["num_attention_heads"], cfg["num_key_value_heads"],
                     cfg["attention_head_dim"])
    r = cfg["adapter_rank"]
    call = (2 * a * (h + 2 * hkv) * dh + 2 * h * dh * d + 2 * 3 * d * f
            + 2 * (d * r + 2 * r * f) + 2 * d * d)
    layers, calls = cfg["num_hidden_layers"], len(cfg["hybrid_layer_ids"])
    attn = sum(fl for fl, _ in attention_calls(cfg, n_image, n_text))
    return float(s * (layers * mamba + calls * call) + layers
                 * _ssd_flops(cfg, s) + attn + 2 * s * d * vocab)


def attention_calls(cfg: Dict, n_image: int,
                    n_text: int) -> List[Tuple[float, float]]:
    """(operations, bytes) of each attention kernel call of one request's
    forward, one a shared-block call."""
    s = n_image + n_text
    h, hkv, dh = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                  cfg["attention_head_dim"])
    flops = 2.0 * causal_pairs(s) * h * (dh + dh)
    nbytes = float((2 * h + 2 * hkv) * s * dh * _BYTES[cfg["torch_dtype"]])
    return [(flops, nbytes)] * len(cfg["hybrid_layer_ids"])
