"""The forward's share of the card's bf16 peak: the frozen count of the
forward operations of the requests completed in the untraced rest of a
traced run's window, over its seconds (the host's clock, read through the
card's events) times the peak rate, in %; nothing to read where there is
no untraced rest or no peak for this card."""


def read(ctx):
    if not ctx.untraced_s or ctx.peak is None or not ctx.untraced_requests:
        return None
    flops = sum(ctx.flops.request_flops(ctx.cfg, n_image, n_text)
                for n_image, n_text in ctx.untraced_requests)
    return 100.0 * flops / (ctx.untraced_s * ctx.peak["bf16_flops_per_s"])
