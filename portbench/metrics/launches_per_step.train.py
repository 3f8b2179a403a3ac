"""Device kernels per traced training step, counted in the trace."""


def read(ctx):
    if ctx.span is None or not ctx.span.units:
        return None
    return len(ctx.span.kernels) / ctx.span.units
