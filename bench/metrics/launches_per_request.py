"""Kernel launches on the card in the traced window (the profiler's device
kernels, copies and sets not counted), over the requests completed in it."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.launches or not ctx.requests:
        return None
    return ctx.trace.launches / len(ctx.requests)
