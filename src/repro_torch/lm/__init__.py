"""The LM stack of the port: the attention families — dense, MoE, MLA, the
vision and audio front ends — and the recurrent ones — the Mamba2 hybrid
(zamba2) and RWKV-6 — with prefill attention through the hand-written
``flash_attention`` kernel on the card, and cached decode."""
