"""The LM stack of the port: dense attention decoders (prefill through the
hand-written ``flash_attention`` kernel on the card, cached decode)."""
