"""Zamba2-7B as published [hf:Zyphra/Zamba2-7B-Instruct config.json].

81 Mamba2 layers (d_model 3584, expand 2, 112 SSM heads of 64, ngroups 2,
d_state 64, d_conv 4, chunk 256); before the mixer of each of the 13
``hybrid_layer_ids`` one of ``num_mem_blocks`` = 2 shared transformer
blocks runs, in turn, on ``concat(x, embedding output)`` (7168 wide):
RMSNorm, attention of 32 heads at dh 224 (q/k/v 7168 -> 7168, o 7168 ->
3584, scale (224 / 2)^-1/2, RoPE theta 10000), RMSNorm, a GeGLU MLP 3584 ->
2 x 14336 -> 3584 with exact GELU and the call's own rank-128 adapter on
gate and up; then the call's own 3584 x 3584 linear, whose output joins x
only at the Mamba2 input: ``x <- x + mamba(norm(x + linear(block)))``.
The Mamba2 gated RMSNorm is grouped over the 2 groups; eps 1e-5; vocab
32000, embeddings tied.  7.36 B parameters.

``zamba2-7b`` (the JAX package's configuration, a narrower shared block in
place of a Mamba2 layer) stays as it is; this is the port's own route
(``block_pattern="zamba2"``).
"""

from .base import SSMConfig, SharedBlockConfig, Zamba2ArchConfig, register

HYBRID_LAYER_IDS = (6, 11, 17, 23, 29, 35, 41, 47, 53, 59, 65, 71, 77)

CONFIG = register(Zamba2ArchConfig(
    name="zamba2-7b-hf",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_head=224,
    d_ff=14336,
    vocab_size=32000,
    mlp_type="glu",
    activation="gelu_exact",
    norm="rmsnorm",
    norm_eps=1e-5,
    rope_theta=10_000.0,
    tie_embeddings=True,
    ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64, n_groups=2,
                  chunk=256),
    shared=SharedBlockConfig(d_attn=7168, layers=HYBRID_LAYER_IDS,
                             attn_scale=(224 / 2) ** -0.5, n_blocks=2,
                             adapter_rank=128),
    block_pattern="zamba2",
    source="[hf:Zyphra/Zamba2-7B-Instruct]",
))
