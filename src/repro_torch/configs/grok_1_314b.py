"""Grok-1 (314B) — 8-expert top-2 MoE [hf:xai-org/grok-1; unverified].

64L, d_model 6144, 48 heads (GQA kv=8), expert d_ff 32768 (GeGLU),
vocab 131072, RMSNorm.  Experts use tensor-parallel sharding ('tp'): 8
experts do not divide the 16-way model axis, so each expert's d_ff is
column-sharded instead (a field the port carries for the multi-GPU slice).
"""

from .base import ArchConfig, MoEConfig, register

CONFIG = register(ArchConfig(
    name="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=32768,
    vocab_size=131072,
    mlp_type="glu",
    activation="gelu",
    norm="rmsnorm",
    rope_theta=10_000.0,
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=32768,
                  expert_sharding="tp"),
    moe_prefill_chunk=4096,
    source="[hf:xai-org/grok-1; unverified]",
))
