"""The LM stack of the port: the attention families — dense, MoE, MLA, the
vision and audio front ends — with prefill through the hand-written
``flash_attention`` kernel on the card, and cached decode."""
