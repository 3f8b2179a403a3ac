"""The training window's peak of allocated device memory, GiB
(``max_memory_allocated`` after ``reset_peak_memory_stats`` at its
start)."""


def read(ctx):
    return ctx.window.get("peak_bytes", 0) / 2 ** 30 or None
