"""Minitron-8B — width-pruned Nemotron-4 [arXiv:2407.14679; hf].

32L, d_model 4096, 32 heads (GQA kv=8), d_ff 16384 (standard MLP with
squared-ReLU, nemotron-style), vocab 256000, RoPE, RMSNorm.
"""

from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="minitron-8b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=16384,
    vocab_size=256000,
    mlp_type="standard",
    activation="relu2",
    norm="layernorm",
    rope_theta=10_000.0,
    source="[arXiv:2407.14679; hf]",
))
