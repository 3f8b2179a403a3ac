"""The conv-formulation prototypes of the JAX package's ``experiments/``, with
their Pallas kernels rewritten as CUDA kernels for Hopper.

Four entry points, each the counterpart of one script, each run as
``python -m vae_cyclegan_tpu_torch.experiments.<name> [--batch 24]
[--device cuda]``:

  * ``conv_proto``: ``experiments/pallas_conv_proto.py`` (NHWC implicit GEMM
    over a padded copy, ``csrc/conv_proto.cu`` on the NHWC conv core
    ``csrc/nhwc_conv.cuh``)
  * ``lowcin_conv2``: ``experiments/pallas_conv2.py`` (channel-major out,
    every Wp column; ``csrc/lowcin_conv.cu`` on the same core, reading a
    padded copy Wp wide as one flat run per image)
  * ``lowcin_conv3``: ``experiments/pallas_conv3.py`` (NHWC out written by
    the kernel; ``csrc/lowcin_nhwc.cu`` on the same core, reading NHWC x
    with the reflect halo in its loader)
  * ``dw_dot_probe``: ``experiments/dw_dot_probe.py`` (the weight-gradient
    dot shapes, ``csrc/dot_probe.cu``)

Importing a module runs nothing: each ``main`` runs only when called or under
``__main__``.
"""
