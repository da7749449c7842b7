"""Qwen1.5-32B — dense MHA model with QKV bias [hf:Qwen/Qwen1.5-32B; hf].

64L, d_model 5120, 40 heads (kv=40, i.e. full MHA), d_ff 27392 (SwiGLU),
vocab 152064, RMSNorm.
"""

from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen1.5-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=40,
    d_ff=27392,
    vocab_size=152064,
    qkv_bias=True,
    mlp_type="glu",
    activation="silu",
    norm="rmsnorm",
    rope_theta=1_000_000.0,
    source="[hf:Qwen/Qwen1.5-32B; hf]",
))
