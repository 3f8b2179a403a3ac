"""The card's idle share over the traced requests, in percent: 1 - the
union of busy intervals over the span's wall time."""

from portbench.metrics import idle_percent


def read(ctx):
    return idle_percent(ctx.span)
