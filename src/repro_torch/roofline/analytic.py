"""Structure-exact analytic cost model: FLOPs, HBM bytes and collective
bytes of one global step.

The port's copy of :mod:`repro.roofline.analytic`, over the port's
:class:`~repro_torch.configs.base.ArchConfig` and ``ShapeSpec``, with the
formulas unchanged (pure Python; nothing here imports torch).  The
reference built it because XLA's ``cost_analysis`` counts a scanned body
once; the port uses it as the bound that a step's measured time is read
against (``chip_smoke.py`` path H divides its training FLOPs by the step
time and the card's peak rate).

All formulas are per *global* step; per-device = /chips (compute, memory) —
collectives are derived per device directly from the sharding policy
(TP all-reduces, FSDP all-gather/reduce-scatter, MoE all-to-all, pod-axis
gradient all-reduce).  On one device pass ``chips=1, tp=1, dp_in_pod=1,
pods=1``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from repro_torch.configs.base import ArchConfig, ShapeSpec

__all__ = ["analytic_cost", "CostBreakdown"]

BF16 = 2
F32 = 4


@dataclasses.dataclass
class CostBreakdown:
    flops_global: float
    hbm_bytes_global: float
    coll_bytes_dev: float
    detail: Dict[str, float]

    def to_dict(self):
        return dataclasses.asdict(self)


def _layer_matmul_params(cfg: ArchConfig) -> Dict[str, float]:
    """Matmul-visited parameter counts per layer kind (no embeddings)."""
    d, dh = cfg.d_model, cfg.head_dim
    out: Dict[str, float] = {}
    if cfg.mla is not None:
        m = cfg.mla
        qk = m.qk_nope_head_dim + m.qk_rope_head_dim
        out["attn"] = (d * m.q_lora_rank + m.q_lora_rank * cfg.n_heads * qk
                       + d * (m.kv_lora_rank + m.qk_rope_head_dim)
                       + m.kv_lora_rank * cfg.n_heads * (m.qk_nope_head_dim + m.v_head_dim)
                       + cfg.n_heads * m.v_head_dim * d)
    else:
        out["attn"] = (d * cfg.n_heads * dh + 2 * d * cfg.n_kv_heads * dh
                       + cfg.n_heads * dh * d)
    mlp_mult = 3 if cfg.mlp_type == "glu" else 2
    out["mlp_dense"] = mlp_mult * d * cfg.d_ff
    if cfg.moe is not None:
        mo = cfg.moe
        out["mlp_dense"] = mlp_mult * d * (mo.d_ff_dense or cfg.d_ff)
        out["mlp_moe_active"] = mlp_mult * d * mo.d_ff_expert * (mo.top_k + mo.n_shared)
        out["mlp_moe_total"] = mlp_mult * d * mo.d_ff_expert * (mo.n_experts + mo.n_shared)
        out["router"] = d * mo.n_experts
    if cfg.ssm is not None:
        s = cfg.ssm
        d_in = s.expand * d
        h = d_in // s.head_dim
        d_proj = 2 * d_in + 2 * s.n_groups * s.d_state + h
        out["mamba_proj"] = d * d_proj + d_in * d
    if cfg.block_pattern == "rwkv":
        out["rwkv_tm"] = 5 * d * d + 2 * d * 64 * 5 + d * 64  # r,k,v,g,o + loras
        out["rwkv_cm"] = d * cfg.d_ff + cfg.d_ff * d + d * d
    return out


def analytic_cost(cfg: ArchConfig, shape: ShapeSpec, *, chips: int,
                  tp: int = 16, dp_in_pod: int = 16, pods: int = 1,
                  microbatches: int = 4, quantized: bool = False,
                  kv_quantized: bool = False,
                  remat: Optional[bool] = None) -> CostBreakdown:
    B, S = shape.global_batch, shape.seq_len
    kind = shape.kind
    d, dh = cfg.d_model, cfg.head_dim
    T = B * (1 if kind == "decode" else S)  # tokens this step
    L_ctx = S  # decode context length
    remat = cfg.remat if remat is None else remat
    lm = _layer_matmul_params(cfg)
    n_attn_layers, n_mamba_layers = cfg._layer_split()
    detail: Dict[str, float] = {}

    # ---------------- FLOPs (forward) ----------------------------------------
    f = 0.0
    # per-token matmul flops: 2 * params_visited
    if cfg.block_pattern == "rwkv":
        per_tok = 2 * (lm["rwkv_tm"] + lm["rwkv_cm"]) * cfg.n_layers
        # wkv state update: ~4 state ops per channel per token x N(=dh)
        per_tok += 4 * cfg.n_layers * d * dh
        f += per_tok * T
    elif cfg.block_pattern == "mamba_hybrid":
        s = cfg.ssm
        d_in = s.expand * d
        h = d_in // s.head_dim
        per_tok_m = 2 * lm["mamba_proj"]
        # SSD core: intra-chunk quadratic + state terms
        chunk = min(s.chunk, S if kind != "decode" else 1)
        per_tok_m += 2 * chunk * h * (s.head_dim + s.d_state)
        per_tok_m += 6 * h * s.head_dim * s.d_state
        f += per_tok_m * T * n_mamba_layers
        per_tok_a = 2 * (lm["attn"] + lm["mlp_dense"])
        f += per_tok_a * T * n_attn_layers
        # shared-attn quadratic term (windowed)
        win = min(cfg.sliding_window or S, S)
        if kind == "decode":
            f += 4 * B * min(L_ctx, win) * cfg.n_heads * dh * n_attn_layers
        else:
            eff = min(win, S)
            f += 2 * 2 * B * S * eff * cfg.n_heads * dh * 0.5 * n_attn_layers
    else:
        per_tok = 2 * lm["attn"] * n_attn_layers
        if cfg.moe is not None:
            mo = cfg.moe
            per_tok += 2 * lm["mlp_dense"] * mo.first_k_dense
            per_tok += 2 * (lm["mlp_moe_active"] + lm["router"]) * (
                n_attn_layers - mo.first_k_dense)
        else:
            per_tok += 2 * lm["mlp_dense"] * n_attn_layers
        f += per_tok * T
        # attention score+context flops
        if cfg.mla is not None:
            qk = cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim
            dv = cfg.mla.v_head_dim
        else:
            qk = dv = dh
        if kind == "decode":
            f += 2 * B * L_ctx * cfg.n_heads * (qk + dv) * n_attn_layers
        else:
            f += 2 * B * S * S * 0.5 * cfg.n_heads * (qk + dv) * n_attn_layers
    # head / embedding matmul
    f += 2 * T * d * cfg.vocab_size
    detail["flops_fwd"] = f

    if kind == "train":
        # bwd = 2x fwd; full remat re-runs fwd once more
        mult = 3.0 + (1.0 if remat else 0.0)
        flops = f * mult
    else:
        flops = f
    detail["flops_total"] = flops

    # ---------------- HBM bytes ----------------------------------------------
    p_total = cfg.param_count()
    p_active = cfg.param_count(active_only=True)
    wbytes = 1 if quantized else BF16
    bts = 0.0
    if kind == "train":
        # params read per microbatch (FSDP re-gather), grads rs/write, opt update
        bts += p_total * BF16 * microbatches  # weight reads
        bts += p_total * F32 * 2  # grad write + read
        mom = 2 if cfg.param_count() > 100e9 else 4
        bts += p_total * mom * 2 * 2  # mu,nu read+write
        bts += p_total * BF16  # param write
        # activations: ~14 tensor r/w of (T, d) per layer per pass (incl norms,
        # attn internals); remat doubles the forward traffic
        passes = 3 + (1 if remat else 0)
        n_layers_eff = cfg.n_layers
        bts += 14 * T * d * BF16 * n_layers_eff * passes / 2
        bts += 3 * T * cfg.vocab_size * F32  # CE logits r/w
    elif kind == "prefill":
        bts += p_total * wbytes
        bts += 10 * T * d * BF16 * cfg.n_layers
        bts += T * cfg.vocab_size * F32
        # KV cache write
        bts += T * cfg.n_kv_heads * dh * 2 * BF16 * n_attn_layers
    else:  # decode
        bts += p_active * wbytes if cfg.moe is not None else p_total * wbytes
        if cfg.moe is not None:
            # non-active expert weights are NOT read, but every resident
            # expert that received >=1 token is; approximate with active set
            # + shared; router read full.
            pass
        # cache read dominates full-attn decode
        if cfg.block_pattern == "rwkv":
            h = cfg.n_heads
            bts += cfg.n_layers * B * h * dh * dh * F32 * 2  # wkv state r/w
        elif cfg.block_pattern == "mamba_hybrid":
            s = cfg.ssm
            d_in = s.expand * d
            h = d_in // s.head_dim
            bts += n_mamba_layers * B * h * s.head_dim * s.d_state * F32 * 2
            win = min(cfg.sliding_window or L_ctx, L_ctx)
            bts += n_attn_layers * B * win * cfg.n_kv_heads * dh * 2 * BF16
        elif cfg.mla is not None:
            m = cfg.mla
            kvb = (1 + F32 / m.kv_lora_rank) if kv_quantized else BF16
            bts += n_attn_layers * B * L_ctx * m.kv_lora_rank * kvb
            bts += n_attn_layers * B * L_ctx * m.qk_rope_head_dim * BF16
        else:
            kvb = (1 + F32 / dh) if kv_quantized else BF16
            bts += n_attn_layers * B * L_ctx * cfg.n_kv_heads * dh * 2 * kvb
        bts += 6 * B * d * BF16 * cfg.n_layers  # activations (tiny)
    detail["hbm_bytes"] = bts

    # ---------------- Collective bytes per device ----------------------------
    act_loc = (T * d * BF16) / (dp_in_pod * pods)  # activations per DP shard
    coll = 0.0
    if cfg.block_pattern == "rwkv":
        ar_per_layer = 2  # tm out-proj + cm out
    elif cfg.block_pattern == "mamba_hybrid":
        ar_per_layer = 1  # out_proj AR; shared-attn adds its own below
    else:
        ar_per_layer = 2  # attn out + mlp out
    n_ar_layers = cfg.n_layers if cfg.block_pattern != "mamba_hybrid" \
        else n_mamba_layers
    passes = (2 if kind == "train" else 1)  # bwd has its own dgrad ARs
    # ring all-reduce moves ~2x the buffer per device
    coll += 2 * ar_per_layer * n_ar_layers * act_loc * passes
    if cfg.block_pattern == "mamba_hybrid":
        coll += 2 * 2 * n_attn_layers * act_loc * passes
    # head all-reduce (vocab-sharded CE reduction is small: lse only)
    coll += 2 * (T / (dp_in_pod * pods)) * F32
    if cfg.moe is not None and kind != "train":
        mo = cfg.moe
        coll += 2 * (T / (dp_in_pod * pods)) * mo.top_k * d * BF16  # a2a round trip
    if kind == "train":
        p_dev = p_total * BF16 / chips
        # FSDP all-gather per microbatch + reduce-scatter grads
        coll += p_total * BF16 / tp * microbatches / max(dp_in_pod, 1) * (dp_in_pod - 1)
        coll += p_total * F32 / tp / max(dp_in_pod, 1) * (dp_in_pod - 1)
        if pods > 1:
            coll += 2 * p_dev  # pod-axis gradient all-reduce (f32/2 ~ bf16*1)
        if cfg.moe is not None:
            mo = cfg.moe
            coll += 2 * (T / (dp_in_pod * pods)) * mo.top_k * d * BF16 * passes
    detail["coll_bytes_dev"] = coll

    return CostBreakdown(flops, bts, coll, detail)
