"""Zamba2's shared transformer blocks, as published (``block_pattern
"zamba2"``; Zyphra's Zamba2-7B, HF ``Zamba2HybridLayer``).

Before the Mamba2 mixer of each layer in ``cfg.shared.layers`` one of
``n_blocks`` shared blocks runs, in turn (0, 1, 0, ...), on
``concat(x, emb)`` (``emb`` the embedding output, 2 d wide): RMSNorm over
2 d, attention of ``n_heads`` heads of ``head_dim`` (q/k/v 2 d -> H dh,
o H dh -> d, the scores times ``attn_scale``, RoPE over the whole head),
RMSNorm over d, the GLU MLP whose gate and up projections each call adds
its own low-rank adapter to (``d -> rank -> d_ff`` twice from one shared
``d -> rank`` projection), and the call's own d x d linear.  The block has
no residual of its own: its output joins x at the Mamba2 input only
(:func:`repro_torch.lm.model` adds it).  The blocks' parameters are
stacked on ``n_blocks``, the calls' linears and adapters on the number of
calls.  On the card a call's attention is one ``flash_attention`` launch
on the kernel's dh-224 instance at the published width.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.spans import span

from . import attention as attn_mod
from .layers import (activation_fn, apply_linear, apply_norm, draw_device,
                     init_linear, make_norm_params, mlp_params)

__all__ = ["shared_params", "shared_call", "shared_decode"]


def shared_params(generator: torch.Generator, cfg: ArchConfig,
                  dtype: torch.dtype) -> Dict:
    """``shared``: the blocks stacked on ``n_blocks``; ``hybrid``: each
    call's linear and adapter, stacked on the calls."""
    sh, d, f = cfg.shared, cfg.d_model, cfg.d_ff
    hd = cfg.n_heads * cfg.head_dim
    kvd = cfg.n_kv_heads * cfg.head_dim
    dev, nb, nc = draw_device(generator), (sh.n_blocks,), (len(sh.layers),)

    def lin(d_in, d_out, lead):
        return init_linear(generator, d_in, d_out, dtype, lead=lead)

    return {
        "shared": {
            "ln_in": make_norm_params(cfg.norm, sh.d_attn, dtype, dev, nb),
            "attn": {"wq": lin(sh.d_attn, hd, nb),
                     "wk": lin(sh.d_attn, kvd, nb),
                     "wv": lin(sh.d_attn, kvd, nb), "wo": lin(hd, d, nb)},
            "ln_ff": make_norm_params(cfg.norm, d, dtype, dev, nb),
            "mlp": mlp_params(generator, d, f, "glu", dtype, nb)},
        "hybrid": {
            "linear": lin(d, d, nc),
            "adapter": {"wa": lin(d, sh.adapter_rank, nc),
                        "wg": lin(sh.adapter_rank, f, nc),
                        "wi": lin(sh.adapter_rank, f, nc)}},
    }


def _mlp(cfg: ArchConfig, mlp: Dict, adapter: Dict, x: torch.Tensor,
         fused: bool) -> torch.Tensor:
    """The block's GLU MLP with the call's adapter added to its gate and up
    projections: ``wo(act(x wg + x wa ag) * (x wi + x wa ai))``."""
    with span("lm.mlp"):
        act = activation_fn(cfg.activation, cfg.gate_sigmoid, fused)
        low = apply_linear(adapter["wa"], x)
        g = apply_linear(mlp["wg"], x) + apply_linear(adapter["wg"], low)
        u = apply_linear(mlp["wi"], x) + apply_linear(adapter["wi"], low)
        with span("lm.gate"):
            h = act(g) * u
        return apply_linear(mlp["wo"], h)


def shared_call(cfg: ArchConfig, block: Dict, call: Dict, x: torch.Tensor,
                emb: torch.Tensor, attn_impl: str,
                kv: Optional[Dict] = None) -> torch.Tensor:
    """One hybrid call over a full sequence: ``linear(block(concat(x,
    emb)))``, (B, S, d).  ``kv``: the call's KV cache slot, written with
    the sequence's keys and values (a prefill into the decode cache)."""
    with span("lm.shared"):
        z = apply_norm(cfg.norm, block["ln_in"], torch.cat([x, emb], -1),
                       cfg.norm_eps)
        with span("lm.attn"):
            a = attn_mod.attention(
                block["attn"], z, n_heads=cfg.n_heads,
                n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
                rope_theta=cfg.rope_theta, causal=True, chunk=cfg.attn_chunk,
                impl=attn_impl, scale=cfg.shared.attn_scale, cache=kv)
        a = apply_norm(cfg.norm, block["ln_ff"], a, cfg.norm_eps)
        m = _mlp(cfg, block["mlp"], call["adapter"], a, attn_impl != "train")
        return apply_linear(call["linear"], m)


def shared_decode(cfg: ArchConfig, block: Dict, call: Dict, x: torch.Tensor,
                  emb: torch.Tensor, kv: Dict,
                  pos: torch.Tensor) -> torch.Tensor:
    """One hybrid call of a decode step: x, emb (B, 1, d); the call's KV
    cache slot updated in place at ``pos``."""
    with span("lm.shared"):
        z = apply_norm(cfg.norm, block["ln_in"], torch.cat([x, emb], -1),
                       cfg.norm_eps)
        a, _ = attn_mod.decode_attention(
            block["attn"], z, kv, pos, n_heads=cfg.n_heads,
            n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
            rope_theta=cfg.rope_theta, scale=cfg.shared.attn_scale)
        a = apply_norm(cfg.norm, block["ln_ff"], a, cfg.norm_eps)
        return apply_linear(call["linear"],
                            _mlp(cfg, block["mlp"], call["adapter"], a, True))
