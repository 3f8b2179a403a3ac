"""Milliseconds per batch the training window's loop waited on the host to
device copy (``Engine.epoch_phases["h2d_wait_ms_per_batch"]``, weighted
over the window's epochs)."""


def read(ctx):
    return ctx.window.get("h2d_wait_ms_per_batch")
