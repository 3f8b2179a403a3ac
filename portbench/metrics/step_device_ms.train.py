"""Device-busy milliseconds per traced training step: the union of the
kernel, copy and set intervals over the span, over its steps."""


def read(ctx):
    if ctx.span is None or not ctx.span.units:
        return None
    return 1000.0 * ctx.span.busy_s / ctx.span.units
