"""Counts for the decoder stack with a prepended image projection.

Per request of ``n_image`` image activations and ``n_text`` tokens
(S = n_image + n_text positions), two operations a multiply-add:

* the image projection: 2 n_image d_proj d;
* per layer and position, the q, k, v and o projections
  2 (d H dh + 2 d Hkv dh + H dh d) and the SwiGLU MLP 2 (3 d d_ff);
* per layer, attention's QK^T and PV over the causal pairs:
  2 pairs H (dh + dh);
* the head: 2 S d V.

These are the formulas of the port's ``roofline/analytic.py``
(``analytic_cost``'s forward FLOPs for a dense config), frozen here, with
two exact terms where it approximates: the causal pairs are S (S + 1) / 2,
not S^2 / 2, and the image projection is counted.

One ``flash_attention`` launch a layer reads q, k and v once and writes o
once, in the model's dtype: (2 H + 2 Hkv) S dh elements.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from . import causal_pairs

__all__ = ["request_flops", "attention_calls"]

_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def _sizes(cfg: Dict):
    return (cfg["hidden_size"], cfg["num_hidden_layers"],
            cfg["num_attention_heads"], cfg["num_key_value_heads"],
            cfg["head_dim"], cfg["intermediate_size"], cfg["vocab_size"])


def request_flops(cfg: Dict, n_image: int, n_text: int) -> float:
    """The forward's operations for one request."""
    d, layers, h, hkv, dh, ff, vocab = _sizes(cfg)
    s = n_image + n_text
    proj = 2 * n_image * cfg.get("projector_hidden_size", d) * d
    per_position = 2 * (d * h * dh + 2 * d * hkv * dh + h * dh * d) \
        + 2 * 3 * d * ff
    attn = sum(f for f, _ in attention_calls(cfg, n_image, n_text))
    return float(proj + per_position * s * layers + attn + 2 * s * d * vocab)


def attention_calls(cfg: Dict, n_image: int,
                    n_text: int) -> List[Tuple[float, float]]:
    """(operations, bytes) of each attention kernel call of one request's
    forward, one a layer."""
    _, layers, h, hkv, dh, _, _ = _sizes(cfg)
    s = n_image + n_text
    pairs = causal_pairs(s, cfg.get("sliding_window"))
    flops = 2.0 * pairs * h * (dh + dh)
    nbytes = float((2 * h + 2 * hkv) * s * dh * _BYTES[cfg["torch_dtype"]])
    return [(flops, nbytes)] * layers
