"""K8: the dw dot probe, ``out (mk, nk) f32 = sum over steps of p . g^T``,
each step's whole product computed afresh and added to an f32 accumulator in
step order.

Counterpart of ``experiments/dw_dot_probe.py`` (``make`` ``:25``, its
``pallas_call`` ``:39``; the probes ``:63-74``). That script timed only the
MXU dots of the weight-gradient kernel's candidate orientations for the k7
and k3 starved convs, on operands held in VMEM over as many grid steps as
the production kernel takes. ``csrc/dot_probe.cu`` runs the same steps as a
loop inside each output tile on the card's tensor cores (bf16) or CUDA cores
(f32). Unlike the JAX script, importing this module runs no probe.

    python -m vae_cyclegan_tpu_torch.experiments.dw_dot_probe [--device cuda]

runs the six probes with the JAX script's names and all-ones bf16 operands
and prints ms per call (ITERS calls per window; JAX timed 20 in one window).
``--batch`` is accepted and unused: the probes' shapes are fixed.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import torch

from vae_cyclegan_tpu_torch.experiments.common import (
    check_operands,
    launch,
    parse_args,
    resolve_device,
)
from vae_cyclegan_tpu_torch.experiments.timing import median_ms, ms_text
from vae_cyclegan_tpu_torch.ops.instance_norm import DTYPE_CODES

# the starved k7 conv's production geometry (dw_dot_probe.py:20-23)
K, WP, R = 7, 262, 16
L = R * WP             # 4192 pixels of a chunk
LP = L + K - 1         # 4198
MX = (R + K - 1) * WP  # 5764: the padded-x domain of a chunk
# (name, mk, nk, kk, steps): dw_dot_probe.py:65-74
SHAPES = [
    ("tail dw current (21,448,Lp)", 24, 448, LP, 384),
    ("tail dw nonswap (448,21->24)", 448, 24, LP, 384),
    ("tail dw wide (64,147,Mx)", 64, 152, MX, 384),
    ("head dw wide (64,147,Mx)", 64, 152, MX, 384),
    ("u4 dw current (96,192)", 96, 192, 16 * 514 + 2, 24 * 8),
    ("u4 dw wide (32,9*64=576)", 32, 576, 18 * 514, 24 * 8),
]
ITERS = 5


def check_probe(p: torch.Tensor, g: torch.Tensor, steps: int) -> None:
    if (p.dim() != 2 or g.dim() != 2 or p.shape[1] != g.shape[1]
            or 0 in p.shape or 0 in g.shape):
        raise ValueError(f"dot_probe: p (mk, kk) and g (nk, kk) of one kk, "
                         f"got {tuple(p.shape)} and {tuple(g.shape)}")
    if steps < 1:
        raise ValueError(f"dot_probe: steps must be >= 1, got {steps}")


def dot_probe_cuda(p: torch.Tensor, g: torch.Tensor,
                   steps: int) -> torch.Tensor:
    """Launch K8: contiguous p (mk, kk) and g (nk, kk) on one CUDA device,
    both float32 or both bfloat16. Returns out (mk, nk) float32. Not
    differentiable: raises under autograd."""
    check_operands("dot_probe", p, g)
    check_probe(p, g, steps)
    (mk, kk), nk = p.shape, g.shape[0]
    out = torch.empty((mk, nk), dtype=torch.float32, device=p.device)
    launch("vct_dot_probe", p.device, p.data_ptr(), g.data_ptr(),
           out.data_ptr(), mk, nk, kk, steps, DTYPE_CODES[p.dtype])
    dot_probe_cuda.launches += 1
    return out


dot_probe_cuda.launches = 0


def dot_probe_reference(p: torch.Tensor, g: torch.Tensor,
                        steps: int) -> torch.Tensor:
    """Plain version of K8: a loop of ``acc = acc + p.float() @ g.float().T``
    over the steps. On the card the caller turns TF32 off
    (``common.resolve_device``)."""
    check_probe(p, g, steps)
    pf, gt = p.float(), g.float().T
    acc = torch.zeros((p.shape[0], g.shape[0]), dtype=torch.float32,
                      device=p.device)
    for _ in range(steps):
        acc = acc + pf @ gt
    return acc


def make(mk: int, nk: int, kk: int, steps: int) -> Callable:
    """The probe's function for p (mk, kk) and g (nk, kk): K8 on CUDA
    tensors, the plain version on the CPU."""

    def f(p: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
        if tuple(p.shape) != (mk, kk) or tuple(g.shape) != (nk, kk):
            raise ValueError(f"dot_probe made for p {(mk, kk)} and g "
                             f"{(nk, kk)}, got {tuple(p.shape)} and "
                             f"{tuple(g.shape)}")
        if p.device.type == "cuda":
            return dot_probe_cuda(p, g, steps)
        return dot_probe_reference(p, g, steps)

    return f


def main(argv: Optional[List[str]] = None, shapes=SHAPES) -> List[dict]:
    """Each probe on all-ones bf16 operands: its time, and its result against
    the plain version (exact: every sum is an integer below 2^24). Returns
    one dict per probe, with ``calls``, the number of probe calls it made."""
    args = parse_args(argv, "K8, the dw dot probe (dw_dot_probe)")
    device = resolve_device(args.device)
    print(f"device={device}", flush=True)
    results = []
    for name, mk, nk, kk, steps in shapes:
        p = torch.ones((mk, kk), dtype=torch.bfloat16, device=device)
        g = torch.ones((nk, kk), dtype=torch.bfloat16, device=device)
        f = make(mk, nk, kk, steps)
        calls = [0]

        def run():
            calls[0] += 1
            return f(p, g)

        got = run()
        err = float((got - dot_probe_reference(p, g, steps)).abs().max())
        dt = median_ms(run, device, ITERS)
        print(f"{name:34s} M={mk:4d} N={nk:4d} K={kk:5d} x{steps}: "
              f"{ms_text(dt)} err={err:g}", flush=True)
        results.append({"name": name, "p": (mk, kk), "g": (nk, kk),
                        "steps": steps, "err": err, "ms": dt,
                        "calls": calls[0]})
    return results


if __name__ == "__main__":
    main()
