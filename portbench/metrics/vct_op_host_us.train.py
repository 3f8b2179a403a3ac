"""Host microseconds per call of a ``vct::`` custom operator in a traced
training step, from the call to its return (torch's dispatcher and custom-op
layer included), over every operator's calls; the median over the span's
steps."""

from portbench.metrics.program_spans import median


def _us(unit):
    calls = sum(o["calls"] for o in unit["ops"].values())
    ns = sum(o["ns"] for o in unit["ops"].values())
    return 1e-3 * ns / calls if calls else None


def read(ctx):
    return median(ctx, "vct.step", _us)
