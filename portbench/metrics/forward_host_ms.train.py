"""Host milliseconds of a traced training step outside its spans: the self
time of ``vct.step`` (its wall time less ``vct.prep``, ``vct.backward``,
``vct.gate`` and ``vct.optimizer``), the generator and discriminator
passes and their losses; the median over the span's steps."""

from portbench.metrics.program_spans import median


def read(ctx):
    return median(ctx, "vct.step", lambda u: 1e-6 * (u["wall_ns"] - sum(
        s["wall_ns"] for s in u["spans"] if s["parent"] is None)))
