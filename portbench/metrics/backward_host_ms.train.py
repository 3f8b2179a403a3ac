"""Host milliseconds of a traced training step in ``vct.backward``
(``torch.autograd.grad``), summed over the step's optimizers; the median
over the span's steps."""

from portbench.metrics.program_spans import median, wall_ns


def read(ctx):
    return median(ctx, "vct.step", lambda u: 1e-6 * wall_ns(u, "vct.backward"))
