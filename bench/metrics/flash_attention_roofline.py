"""The attention kernel's share of its roofline, in %: the least time the
card could take for the attention the window's requests called (each call's
operations at the bf16 peak or its bytes at the memory peak, whichever is
longer; the benchmark's own count, whatever implements it), over the
device time of the kernels named ``flash_attention_kernel``."""

KERNEL = "flash_attention_kernel"


def read(ctx):
    if ctx.trace is None or ctx.peak is None or not ctx.requests:
        return None
    device_s = sum(s for name, s in ctx.trace.device_s_by_name.items()
                   if KERNEL in name)
    if device_s <= 0:
        return None
    bound_s = sum(
        max(f / ctx.peak["bf16_flops_per_s"], b / ctx.peak["hbm_bytes_per_s"])
        for n_image, n_text in ctx.requests
        for f, b in ctx.flops.attention_calls(ctx.cfg, n_image, n_text))
    return 100.0 * bound_s / device_s
