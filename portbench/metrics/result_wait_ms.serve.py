"""Host milliseconds of a traced request in ``vct.to_host``: the clip, the
copy back and the wait for the device's result; the median over the span's
requests."""

from portbench.metrics.program_spans import median, wall_ns


def read(ctx):
    return median(ctx, "vct.request", lambda u: 1e-6 * wall_ns(
        u, "vct.to_host"))
