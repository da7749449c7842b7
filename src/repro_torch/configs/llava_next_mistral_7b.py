"""LLaVA-NeXT (Mistral-7B backbone) [hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified].

Backbone only per assignment: 32L, d_model 4096, 32 heads (GQA kv=8),
d_ff 14336 (SwiGLU), vocab 32000.  The anyres vision frontend is a STUB:
``input_specs()`` provides up to 5 tiles x 576 = 2880 precomputed patch
embeddings per example, prepended to the token sequence.
"""

from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    mlp_type="glu",
    activation="silu",
    norm="rmsnorm",
    rope_theta=1_000_000.0,
    modality="vision",
    n_prefix_embeds=2880,
    source="[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]",
))
