"""Synchronising CUDA calls per traced training step, counted from the
warnings ``torch.cuda.set_sync_debug_mode("warn")`` raises over the span
(the harness's filter records every one)."""


def read(ctx):
    if ctx.span is None or not ctx.span.units or ctx.syncs is None:
        return None
    return ctx.syncs / ctx.span.units
