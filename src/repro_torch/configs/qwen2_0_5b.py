"""Qwen2-0.5B — small dense GQA model with QKV bias [arXiv:2407.10671; hf].

24L, d_model 896, 14 heads (GQA kv=2), d_ff 4864 (SwiGLU), vocab 151936,
tied embeddings, RMSNorm.
"""

from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen2-0.5b",
    family="dense",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_ff=4864,
    vocab_size=151936,
    qkv_bias=True,
    mlp_type="glu",
    activation="silu",
    norm="rmsnorm",
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    source="[arXiv:2407.10671; hf]",
))
