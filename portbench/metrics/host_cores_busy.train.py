"""The process's CPU time over the wall time of a traced training step
(``vct.step``'s ``process_ns``: the dispatching thread, the loader's and
the copy thread, CUDA's own), in cores; the median over the span's
steps."""

from portbench.metrics.program_spans import median


def read(ctx):
    return median(ctx, "vct.step",
                  lambda u: u["process_ns"] / u["wall_ns"]
                  if u["wall_ns"] > 0 else None)
