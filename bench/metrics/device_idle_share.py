"""The share of the traced window's wall time in which nothing (no kernel,
copy or set) ran on the card, in %; nothing to read where nothing ran
on a card."""


def read(ctx):
    if ctx.trace is None or ctx.trace.window_s <= 0 or not ctx.trace.busy_s:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
