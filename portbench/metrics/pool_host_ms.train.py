"""Host milliseconds of a traced training step in ``vct.pool`` (the history
pools' queries: the decisions on the host, the index copy and the two
gathers issued), summed over the step's queries; the median over the span's
steps. None where the steps hold no such span."""

from portbench.metrics.program_spans import median


def _ms(unit):
    spans = [s for s in unit["spans"] if s["name"] == "vct.pool"]
    return 1e-6 * sum(s["wall_ns"] for s in spans) if spans else None


def read(ctx):
    return median(ctx, "vct.step", _ms)
