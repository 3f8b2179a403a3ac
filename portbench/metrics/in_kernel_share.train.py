"""Per cent of the in-process InstanceNorm + activation sites of a traced
training span that ran on a hand kernel (K1 or K2, forward; their backward
follows the forward's path): the ``instance_norm.kernel`` count against it
plus ``instance_norm.plain``, summed over the span's ``vct.step`` units
(``vae_cyclegan_tpu_torch.ops.instance_norm.instance_norm_act``). None
where the units hold no such count."""

from portbench.metrics.program_spans import units


def read(ctx):
    got = units(ctx, "vct.step")
    if got is None:
        return None
    counts = [u.get("counts", {}) for u in got]
    kernel = sum(c.get("instance_norm.kernel", 0) for c in counts)
    plain = sum(c.get("instance_norm.plain", 0) for c in counts)
    total = kernel + plain
    return 100.0 * kernel / total if total else None
