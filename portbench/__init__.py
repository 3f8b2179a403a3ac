"""The benchmark of the PyTorch/CUDA port (``vae_cyclegan_tpu_torch``):
``python3 -m portbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``. See ``README``."""
