"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the full 700 W power limit). Shares are stated
against these, with the card's power limit printed beside them."""

HBM_BYTES_PER_S = 3.35e12
FLOPS_PER_S = {"bfloat16": 989e12, "float16": 989e12, "tf32": 495e12,
               "float32": 67e12}
