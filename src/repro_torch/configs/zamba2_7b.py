"""Zamba2-7B — Mamba2 backbone + shared attention blocks [arXiv:2411.15242; unverified].

81 layers, d_model 3584: Mamba2 blocks (state 64, expand 2, head_dim 64)
with one *shared* full-attention+MLP block (32 heads, d_ff 14336) invoked
every 6th position — the shared-parameter design of the Zamba family.
vocab 32000.  Sub-quadratic: runs long_500k (decode state is O(1); the
shared attention block uses a sliding window at 500k).
"""

from .base import ArchConfig, SSMConfig, register

CONFIG = register(ArchConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14336,
    vocab_size=32000,
    mlp_type="glu",
    activation="gelu",
    norm="rmsnorm",
    rope_theta=10_000.0,
    sliding_window=4096,
    ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64, n_groups=2,
                  chunk=128, shared_attn_every=6),
    block_pattern="mamba_hybrid",
    source="[arXiv:2411.15242; unverified]",
))
