"""The starved conv (K3, ``vct::starved_conv``, forward and dx) against its
roofline over the traced training steps (the span with the host operators
and their shapes), in percent
(``starved_conv_work``)."""

from portbench.metrics.starved_conv_work import roofline_percent


def read(ctx):
    return roofline_percent(ctx.op_span)
