"""Per cent of the batches the loader queued over a traced training span
that were built in worker processes: the ``loader_batches.processes``
count against it plus ``loader_batches.threads``, summed over the span's
``vct.step`` units (``vae_cyclegan_tpu_torch.data.loader``). None where the
units hold no such count."""

from portbench.metrics.program_spans import units


def read(ctx):
    got = units(ctx, "vct.step")
    if got is None:
        return None
    counts = [u.get("counts", {}) for u in got]
    processes = sum(c.get("loader_batches.processes", 0) for c in counts)
    threads = sum(c.get("loader_batches.threads", 0) for c in counts)
    total = processes + threads
    return 100.0 * processes / total if total else None
