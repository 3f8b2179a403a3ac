"""PyTorch/CUDA port of ``vae_cyclegan_tpu`` for one NVIDIA H100.

Plain PyTorch ``nn.Module``s (NCHW inside, NHWC at the task's public
boundary) with the JAX package's Pallas kernels rewritten as CUDA C++
kernels for Hopper (``csrc/``, built by ``kernels.load`` at first use). The
JAX package is the reference the port is tested against; this package
imports neither it nor JAX.

Ported so far: the ten tasks (``models.tasks.create_task``: serving,
training and evaluation), the data path and the epoch engine, and the
drivers ``python -m vae_cyclegan_tpu_torch.train`` / ``.test`` with their
checkpoints, transfer, NaN dumps, TensorBoard, preemption and FID
(``utils``), remat, the generator export (``.export``, ``utils.export``)
with the kernels as ``vct::`` custom operators (``kernels.ops``), the
checkpoint import (``.import_checkpoint``) and the trajectory harness
(``.parity_curves``). Data parallelism is not ported yet.
"""

from vae_cyclegan_tpu_torch.config import LossConfig, ModelConfig, OptimConfig
