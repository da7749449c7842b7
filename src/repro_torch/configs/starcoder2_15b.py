"""StarCoder2-15B — dense GQA code model [arXiv:2402.19173; hf].

40L, d_model 6144, 48 heads (GQA kv=4), d_ff 24576 (standard 2-matrix MLP,
GELU), vocab 49152, RoPE, learned bias on QKV, LayerNorm.
"""

from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="starcoder2-15b",
    family="dense",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=4,
    d_ff=24576,
    vocab_size=49152,
    qkv_bias=True,
    mlp_type="standard",
    activation="gelu",
    norm="layernorm",
    rope_theta=100_000.0,
    source="[arXiv:2402.19173; hf]",
))
