"""Host microseconds per call of the model path's kernel sites, on the card.

    python -m vae_cyclegan_tpu_torch.host_cost [--iters 100]

Times, on the host's clock and without a synchronize, the calls through
which the serving path (batch 1, no autograd) and the training step
(batch 4, autograd recording) reach K1 and K3, and the step's backward
calls that reach K3's zero_same mode and K4, at the full-width bf16 shapes
(the identity IN site (n, 1024, 16, 16), U4's conv (n, 32, 256, 256) with a
(64, 32, 3, 3) weight, and its dx and dw), plus one whole ``generate`` at
batch 1. Each timing covers `iters` calls after a synchronize, few enough
that the launch queue does not fill, so it reads the host's own cost of a
call while the card runs behind it. Prints the card's name and power limit
and one JSON line of microseconds per call.

It uses only entry points that the port has had since its training step
was ported (``ops.instance_norm.instance_norm_act``, ``ops.starved_conv``'s
``starved_reflect_conv``, ``_zero_same``, ``_dw`` and ``rotate``, the
tasks), so a copy of it runs against an earlier tree of the port as well:
that is how two versions of the path are compared in one call.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch


def host_us(fn, iters: int) -> float:
    """Host microseconds per call over `iters` calls, after a synchronize,
    without one inside: the call's own cost while the card runs behind it
    (where the card is the slower side, the launch queue fills and this
    reads the card)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    us = (time.perf_counter() - t0) / iters * 1e6
    torch.cuda.synchronize()
    return us


def measure(iters: int = 100, device="cuda") -> dict:
    """{call: host us per call} (module docstring), each the median of
    five timings of `iters` calls after three warm-up calls."""
    from vae_cyclegan_tpu_torch.config import ModelConfig
    from vae_cyclegan_tpu_torch.models.tasks import create_task
    from vae_cyclegan_tpu_torch.ops import starved_conv as sc
    from vae_cyclegan_tpu_torch.ops.instance_norm import instance_norm_act

    dev = torch.device(device)
    b16 = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(0)

    def rand(*shape, grad=False):
        t = torch.randn(shape, generator=gen, device=dev).to(b16)
        return t.requires_grad_(grad)

    calls = {}  # name -> (call, whether autograd records)
    for n, grad in ((1, False), (4, True)):
        path = "step_b4" if grad else "serving_b1"
        x_in = rand(n, 1024, 16, 16, grad=grad)
        x_conv = rand(n, 32, 256, 256, grad=grad)
        w = rand(64, 32, 3, 3, grad=grad)
        calls[f"in_act_{path}"] = (lambda x=x_in: instance_norm_act(
            x, act="relu", order="act_norm"), grad)
        calls[f"starved_conv_{path}"] = (
            lambda x=x_conv, w=w: sc.starved_reflect_conv(x, w), grad)
    g = rand(4, 64, 256, 256)
    x = rand(4, 32, 256, 256)
    wrot = sc.rotate(rand(64, 32, 3, 3)).contiguous()
    calls["starved_conv_dx_step_b4"] = (lambda: sc._zero_same(g, wrot), False)
    calls["starved_dw_step_b4"] = (lambda: sc._dw(x, g, 3), False)
    task = create_task("cyclevaegan", model=ModelConfig(256, 64, 64, b16),
                       device=dev)
    task.init(0)
    image = torch.rand(1, 256, 256, 3, generator=gen, device=dev)
    eps = torch.randn(1, 16, 16, 64, generator=gen, device=dev)
    calls["generate_b1"] = (lambda: task.generate({"x": image}, eps=eps),
                            False)

    out = {}
    for name, (fn, grad) in calls.items():
        with torch.set_grad_enabled(grad):
            for _ in range(3):
                fn()
            runs = sorted(host_us(fn, iters) for _ in range(5))
        out[name] = runs[2]
    return out


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--iters", type=int, default=100)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("host_cost: no CUDA device; it times calls on the "
                         "card")
    torch.backends.cudnn.allow_tf32 = False
    result = measure(args.iters)
    print(f"card (name, power.limit): {card()}")
    print(json.dumps({"host_us_per_call": result}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
