"""Per cent of the images the history pools handed the discriminators over
a traced training span that came from the history, not fresh from the
generators: the ``image_pool.history`` count against it plus
``image_pool.fresh``, summed over the span's ``vct.step`` units
(``vae_cyclegan_tpu_torch.models.image_pool``); near 50 once the pools are
full. None where the units hold no such count."""

from portbench.metrics.program_spans import units


def read(ctx):
    got = units(ctx, "vct.step")
    if got is None:
        return None
    counts = [u.get("counts", {}) for u in got]
    history = sum(c.get("image_pool.history", 0) for c in counts)
    fresh = sum(c.get("image_pool.fresh", 0) for c in counts)
    total = history + fresh
    return 100.0 * history / total if total else None
