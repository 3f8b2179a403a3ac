"""Host milliseconds of a traced training step in ``vct.gate``, the finite
gate (the gradient mean in a group, then the host's read of the loss's
finiteness, which waits for the device: the step's syncs), summed over the
step's optimizers; the median over the span's steps."""

from portbench.metrics.program_spans import median, wall_ns


def read(ctx):
    return median(ctx, "vct.step", lambda u: 1e-6 * wall_ns(u, "vct.gate"))
