"""The reference against the program's plain CPU path, and its
independence: it imports nothing of the program or of JAX."""

import ast
import json
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import check, harness, weights
from portbench.reference import data as ref_data
from portbench.reference.steps import family

REF = Path(__file__).resolve().parents[1] / "reference"
CONFIGS = ["cyclevaegan-256", "vaegan-256"]


def _cfg(name, **kw):
    cfg = json.loads((harness.HERE / "configs" / f"{name}.json").read_text())
    cfg.update(image_size=64, base_width=8, latent_dim=8,
               compute_dtype="float32", **kw)
    return cfg


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("paired", [False, True])
def test_step_matches_the_programs_plain_path(name, paired):
    """One training step at image 64, base 8 in f32 on the CPU: the same
    losses, and every leaf's gradient (the program's as Adam got it) and
    change within rounding of the median leaf. The gradients' bar is f32
    rounding amplified by InstanceNorm over the 4x4 bottleneck planes of a
    64-pixel image (0.3% at 128 pixels, 1.1% at 64, in the encoders)."""
    from portbench.drivers.train import build_task

    cfg = _cfg(name, paired=paired)
    task = build_task(cfg, 5, "cpu")
    fam = family(cfg)
    fam.load(weights.make(cfg, harness.sub_seed(5, 0), "cpu"))
    torch.manual_seed(1)
    x, y = torch.rand(2, 64, 64, 3), torch.rand(2, 64, 64, 3)
    m = task.train_step({"x": x, "y": y},
                        generator=torch.Generator().manual_seed(3))
    mine, gg, dg = fam.step(x.permute(0, 3, 1, 2), y.permute(0, 3, 1, 2),
                            torch.Generator().manual_seed(3))
    assert set(mine) <= set(m)
    for k, v in mine.items():
        assert check.rel(float(m[k]), v) < 1e-4, k
    names = {id(p): n for n, p in fam.nets.named_parameters()}
    ref = {names[id(p)]: float(t.norm())
           for p, t in zip(fam.gen_params + fam.disc_params, gg + dg)}
    params = dict(task.nets.named_parameters())
    prog = {}
    for n, p in params.items():
        for opt in task.optimizers().values():
            if p in opt.state:
                prog[n] = float(opt.state[p]["exp_avg"].norm() / 0.5)
    assert check.leaf_gap(prog, ref) < 2e-2
    start = weights.make(cfg, harness.sub_seed(5, 0), "cpu")
    moved = {n: float((p.detach() - start[n]).norm())
             for n, p in params.items()}
    mine = {n: float((p.detach() - start[n]).norm())
            for n, p in fam.nets.named_parameters()}
    assert check.leaf_gap(moved, mine, check.moving_leaves(ref)) < 1e-3


def test_generate_matches_the_program():
    from portbench.drivers.train import build_task
    from vae_cyclegan_tpu_torch.inference import run_inference

    cfg = _cfg("cyclevaegan-256")
    task = build_task(cfg, 7, "cpu")
    fam = family(cfg)
    fam.load(weights.make(cfg, harness.sub_seed(7, 0), "cpu"))
    x = np.random.RandomState(0).rand(3, 64, 64, 3).astype(np.float32)
    got = run_inference(task, {"x": x}, seed=11)
    want = fam.generate(torch.from_numpy(x).permute(0, 3, 1, 2),
                        torch.Generator().manual_seed(11)).clamp(0, 1)
    want = want.permute(0, 2, 3, 1).numpy()
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 1e-5
    assert np.abs(got - want).max() < 1e-3


def test_state_dict_keys_are_the_programs():
    from portbench.drivers.train import build_task

    for name in CONFIGS:
        cfg = _cfg(name)
        task = build_task(cfg, 1, "cpu")
        assert set(task.state_dict()) == set(weights.shapes(cfg))


def test_device_resize_matches_the_programs_device_aug():
    """The reference's resampling matrices against the program's on-card
    augmentation (run on the CPU) for crops, flips and both directions."""
    from vae_cyclegan_tpu_torch.data.device_aug import device_augment

    rng = np.random.RandomState(0)
    raw = rng.randint(0, 256, (4, 60, 80, 3)).astype(np.uint8)
    boxes = [(0, 0, 0, 0, 60), (1, 0, 5, 7, 40), (0, 1, 30, 12, 17),
             (1, 1, 2, 3, 55)]
    aug = torch.tensor([[h, v, t, l, s, s] for h, v, t, l, s in boxes],
                       dtype=torch.float32)
    got = device_augment(torch.from_numpy(raw), aug, 32)
    for i, box in enumerate(boxes):
        want = ref_data.resize_on(raw[i], box, 32, "cpu").permute(1, 2, 0)
        assert float((got[i] - want).abs().max()) < 1e-5


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(REF.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(REF)))
def test_reference_imports_nothing_of_the_program(path):
    banned = set(harness.FORBIDDEN) | {"vae_cyclegan_tpu_torch"}
    tops = {name.split(".")[0] for name in _imports(path)}
    assert not tops & banned, tops & banned


def test_reference_loads_nothing_of_the_program():
    code = ("import sys, portbench.reference.steps, portbench.reference.data,"
            " portbench.reference.flops, portbench.weights\n"
            "from portbench.reference import datasets, families\n"
            "for name in ('cyclevaegan', 'vaegan'):\n"
            "    __import__('portbench.reference.families.' + name)\n"
            "for name in ('summer2winter', 'hypersim'):\n"
            "    datasets.module(name)\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True,
                         cwd=harness.ROOT).stdout
    loaded = set(json.loads(out.replace("'", '"')))
    assert not loaded & (set(harness.FORBIDDEN) | {"vae_cyclegan_tpu_torch"})


def test_flop_count_is_the_published_step():
    """Per image: cyclevaegan 1.05 TFLOP a training step and 71 GFLOP a
    generator forward, vaegan 0.45 TFLOP (FlopCounterMode on meta)."""
    from portbench.reference import flops

    cyc = json.loads((harness.HERE / "configs/cyclevaegan-256.json").read_text())
    vae = json.loads((harness.HERE / "configs/vaegan-256.json").read_text())
    assert math.isclose(flops.per_image(cyc, "train", 2), 1.051445428224e12,
                        rel_tol=1e-9)
    assert math.isclose(flops.per_image(cyc, "serve", 2), 71.036829696e9,
                        rel_tol=1e-9)
    assert math.isclose(flops.per_image(vae, "train", 2), 0.45345275904e12,
                        rel_tol=1e-9)
