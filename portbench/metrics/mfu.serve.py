"""Model FLOP utilisation of the serving window: the generator forward's
FLOPs per image (the reference counted on meta tensors) times the images
returned per second, over the bf16 peak, in percent."""

from portbench.metrics import model_flops_percent as _mfu


def read(ctx):
    return _mfu(ctx, "serve")
