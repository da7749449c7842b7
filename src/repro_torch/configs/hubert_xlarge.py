"""HuBERT X-Large — encoder-only audio model [arXiv:2106.07447; unverified].

48L, d_model 1280, 16 heads (full MHA), d_ff 5120 (standard MLP, GELU),
LayerNorm; 504-unit masked-prediction vocabulary.  The conv waveform
frontend is a STUB per assignment: ``input_specs()`` provides precomputed
frame embeddings (B, T, d_model).  Encoder-only: no decode shapes.
"""

from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    d_ff=5120,
    vocab_size=504,
    mlp_type="standard",
    activation="gelu",
    norm="layernorm",
    encoder_only=True,
    modality="audio",
    source="[arXiv:2106.07447; unverified]",
))
