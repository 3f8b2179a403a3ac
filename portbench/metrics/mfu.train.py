"""Model FLOP utilisation of the training window: the forward and backward
FLOPs one image needs (the reference's step counted by
``FlopCounterMode`` on meta tensors, nothing recomputed) times the window's
images per second, over the bf16 peak, in percent."""

from portbench.metrics import model_flops_percent as _mfu


def read(ctx):
    return _mfu(ctx, "train")
