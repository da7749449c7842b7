"""DeepSeek-V3 (671B) — MLA + 256-expert top-8 MoE [arXiv:2412.19437; hf].

61L, d_model 7168, 128 heads with Multi-head Latent Attention
(q_lora 1536, kv_lora 512, qk_nope 128 + qk_rope 64, v 128), MoE with 1
shared + 256 routed experts (top-8, aux-loss-free balancing), expert
d_ff 2048, first 3 layers dense (d_ff 18432), vocab 129280.  Experts use
expert-parallel sharding (256/16 = 16 experts per model shard).

MTP (multi-token prediction) is not modelled: training and the dry-run use
the standard next-token objective.
"""

from .base import ArchConfig, MLAConfig, MoEConfig, register

CONFIG = register(ArchConfig(
    name="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    d_ff=18432,
    vocab_size=129280,
    mlp_type="glu",
    activation="silu",
    norm="rmsnorm",
    rope_theta=10_000.0,
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                  qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(n_experts=256, top_k=8, d_ff_expert=2048, n_shared=1,
                  first_k_dense=3, d_ff_dense=18432, expert_sharding="ep",
                  router_aux_free=True),
    moe_prefill_chunk=4096,
    source="[arXiv:2412.19437; hf]",
))
