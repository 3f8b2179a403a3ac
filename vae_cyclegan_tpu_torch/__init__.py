"""PyTorch/CUDA port of ``vae_cyclegan_tpu`` for one NVIDIA H100.

Plain PyTorch ``nn.Module``s (NCHW inside, NHWC at the task's public
boundary) with the JAX package's Pallas kernels rewritten as CUDA C++
kernels for Hopper (``csrc/``, built by ``kernels.load`` at first use). The
JAX package is the reference the port is tested against; this package
imports neither it nor JAX.

Ported so far: the cyclevaegan task, ``models.tasks.create_task(
"cyclevaegan", ...)``: its serving path (``inference.run_inference``) and
its training step (``train_step`` / ``eval_step``).
"""

from vae_cyclegan_tpu_torch.config import LossConfig, ModelConfig, OptimConfig
