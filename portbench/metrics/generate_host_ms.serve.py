"""Host milliseconds of a traced request in ``vct.generate``, the
generator's forward as the host issues it; the median over the span's
requests."""

from portbench.metrics.program_spans import median, wall_ns


def read(ctx):
    return median(ctx, "vct.request", lambda u: 1e-6 * wall_ns(
        u, "vct.generate"))
