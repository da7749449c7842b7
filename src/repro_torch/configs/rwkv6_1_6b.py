"""RWKV-6 'Finch' 1.6B — attention-free, data-dependent decay [arXiv:2404.05892; unverified].

24L, d_model 2048 (32 heads x 64), d_ff 7168 channel-mix, vocab 65536.
Linear recurrence: runs long_500k (O(1) decode state).  The paper's PWL
sigmoid applies natively to its receptance/gate sigmoids.
"""

from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="rwkv6-1.6b",
    family="ssm",
    n_layers=24,
    d_model=2048,
    n_heads=32,  # wkv heads = d_model / head_dim(64)
    n_kv_heads=32,
    d_head=64,
    d_ff=7168,
    vocab_size=65536,
    mlp_type="standard",
    activation="relu2",  # channel-mix uses squared relu
    norm="layernorm",
    block_pattern="rwkv",
    source="[arXiv:2404.05892; unverified]",
))
