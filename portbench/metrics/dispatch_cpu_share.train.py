"""Per cent of a traced training step's wall time the dispatching threads
spent on a CPU (``vct.step``'s ``cpu_ns``: the step's thread, and in each
``vct.backward`` the autograd engine's device thread), its ``vct.gate``
spans, where the host waits on the device, left out; the median over the
span's steps. Low: the dispatching thread is starved of a core."""

from portbench.metrics.program_spans import median


def _share(unit):
    gates = [s for s in unit["spans"] if s["name"] == "vct.gate"]
    wall = unit["wall_ns"] - sum(s["wall_ns"] for s in gates)
    cpu = unit["cpu_ns"] - sum(s["cpu_ns"] for s in gates)
    return 100.0 * cpu / wall if wall > 0 else None


def read(ctx):
    return median(ctx, "vct.step", _share)
