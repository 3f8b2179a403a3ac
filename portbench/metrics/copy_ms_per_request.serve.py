"""Device milliseconds of host <-> device copies per traced request (the
trace's memcpy intervals over its requests)."""


def read(ctx):
    if ctx.span is None or not ctx.span.units or not ctx.span.copies:
        return None
    return 1000.0 * sum(d for _, _, _, d in ctx.span.copies) / ctx.span.units
