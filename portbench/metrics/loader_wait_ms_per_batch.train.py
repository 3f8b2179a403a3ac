"""Milliseconds per batch the training window's loop waited on the loader
(``Engine.epoch_phases["host_ms_per_batch"]``, weighted over the window's
epochs)."""


def read(ctx):
    return ctx.window.get("host_ms_per_batch")
