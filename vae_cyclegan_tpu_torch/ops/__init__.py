"""Compute ops of the port: padding, pixel (un)shuffle, fused instance norm,
reflect conv, the starved-conv dispatcher and initializers (NCHW)."""

from vae_cyclegan_tpu_torch.ops.padding import reflect_pad
from vae_cyclegan_tpu_torch.ops.pixel_shuffle import pixel_shuffle, pixel_unshuffle
from vae_cyclegan_tpu_torch.ops.instance_norm import instance_norm_act
from vae_cyclegan_tpu_torch.ops.initializers import kaiming_normal_fan_out
from vae_cyclegan_tpu_torch.ops.reflect_conv import reflect_conv
from vae_cyclegan_tpu_torch.ops.starved_conv import starved_reflect_conv
