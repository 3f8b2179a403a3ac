"""The two cells of the CycleGAN configuration and of data parallelism on
the CPU: the new family's weights and FLOP count, the blocked reference
step against the whole-batch one, a tiny-size harness run of each cell
(``cyclegan.s2w.train.b24``'s configuration; ``train_dp`` over two gloo
ranks), and the lower-precision control against the data-parallel cell's
limits (``test_portbench_harness.py``'s control test maps only the
``train`` and ``serve`` drivers to tiny parameters)."""

import json
import math
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import check, harness, weights
from portbench.reference import blocked, flops
from portbench.reference.nets import Precision
from portbench.reference.steps import family
from portbench.tests import tiny

CELL = "cyclegan.s2w.train.b24"
DP_CELL = "cyclevaegan.s2w.train.dp4"


def _cfg(**kw):
    _, cfg = harness.cell_files(CELL)
    return {**cfg, **kw}


def test_weights_follow_the_programs_keys_and_gains():
    """``weights.make`` draws the program's keys and shapes; generator convs
    Kaiming-normal with the ReLU gain over fan_out, the discriminators'
    with the LeakyReLU(0.2) gain (``d_init``), every bias zero."""
    from vae_cyclegan_tpu_torch.config import ModelConfig
    from vae_cyclegan_tpu_torch.models.tasks import create_task

    cfg = _cfg()
    shapes = weights.shapes(cfg)
    task = create_task("cyclegan", model=ModelConfig(256, 64, 64),
                       device="meta")
    assert shapes == {k: v.shape for k, v in task.state_dict().items()}
    w = weights.make(cfg, 3, "cpu")
    g = w["G_A.model.10.conv_block.1.weight"]
    assert abs(float(g.std()) / math.sqrt(2 / (256 * 9)) - 1) < 0.01
    d = w["D_B.model.8.weight"]
    assert abs(float(d.std()) / math.sqrt(2 / 1.04 / (512 * 16)) - 1) < 0.01
    assert all(float(v.abs().max()) == 0 for k, v in w.items()
               if k.endswith("bias"))


def test_flop_count_of_a_step():
    """1.879 TFLOP an image at 256x256 (six generator passes and two
    discriminator passes forward and backward in the G step, four
    discriminator passes in the D step), 99.1 GFLOP a translation."""
    cfg = _cfg()
    assert abs(flops.per_image(cfg, "train", 24) / 1.879e12 - 1) < 0.01
    assert abs(flops.per_image(cfg, "serve", 24) / 99.1e9 - 1) < 0.01


def test_blocked_step_is_the_whole_batch_step():
    """The reference's generator step in blocks of one sample is the whole
    batch's, in f64 (where the InstanceNorm backward's amplified rounding,
    1% of a leaf at this size in f32, is gone): losses and every gradient
    leaf to 1e-9, the pools fed the same fakes."""
    cfg = _cfg(image_size=64, base_width=8)
    start = weights.make(cfg, 4, "cpu")
    x, y = (torch.rand(3, 3, 64, 64, dtype=torch.float64) for _ in "xy")
    got = []
    for block in (3, 1):
        fam = family(cfg)
        fam.load(start)
        fam.nets.double()
        fam.stream = torch.Generator().manual_seed(8)
        got.append(blocked.step(fam, x, y, None, block))
    (m1, g1, d1), (m2, g2, d2) = got
    for k, v in m1.items():
        assert abs(m2[k] - v) <= 1e-9 * max(abs(v), 1e-3), k
    median = float(np.median([float(t.norm()) for t in g1 + d1]))
    for a, b in zip(g1 + d1, g2 + d2):
        assert float((a - b).norm()) <= 1e-9 * max(float(a.norm()), median)


def _tree(dest: Path):
    """The tiny harness tree with a CycleGAN cell and a two-rank
    data-parallel cell added."""
    tiny.make_tree(dest)
    pb = dest / "portbench"
    bench = json.loads((dest / "BENCHMARK.json").read_text())
    cfg = json.loads((harness.HERE / "configs"
                      / "cyclegan-resnet9-256.json").read_text())
    cfg.update(tiny.TINY, name="tiny-cyclegan", compute_dtype="float32")
    (pb / "configs" / "tiny-cyclegan.json").write_text(json.dumps(cfg))
    bench["configs"].append({**bench["configs"][0], "name": "tiny-cyclegan",
                             "file": "portbench/configs/tiny-cyclegan.json"})
    params = dict(tiny.PARAMS["tiny.s2w.train"])
    cells = {
        "tiny.cyclegan.train": dict(config="tiny-cyclegan", driver="train",
                                    chips=1, params=params),
        "tiny.dp.train": dict(config="tiny-cyclevaegan-256",
                              driver="train_dp", chips=2,
                              params={**params, "frames_a": 9,
                                      "batch_size": 4, "num_workers": 1}),
    }
    for name, c in cells.items():
        cell = {"name": name, "traffic": name, "why": name,
                "limits": tiny.LIMITS["train"], **c}
        (pb / "workloads" / f"{name}.json").write_text(json.dumps(cell))
        bench["workloads"].append({k: cell[k] for k in
                                   ("name", "config", "traffic", "chips",
                                    "why")})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if m["name"].endswith(("train", "train_images_per_s")):
                m.setdefault("workloads", []).append(name)
    (dest / "BENCHMARK.json").write_text(json.dumps(bench))
    return dest


@pytest.mark.parametrize("cell", ["tiny.cyclegan.train", "tiny.dp.train"])
def test_tiny_run_of_the_new_cells(cell, tmp_path):
    """Each new cell's harness run on the CPU at a tiny size: the contract
    line, correct against the f32 reference at step 1, every step counted
    (the data-parallel cell's global batch over two gloo ranks)."""
    tree = _tree(tmp_path)
    rc, out, err = tiny.run(tree, ["--workload", cell, "--seed",
                                   str(2 ** 31 + 19), "--seconds", "1",
                                   "--trace", "1"])
    assert rc == 0, err[-3000:]
    line = json.loads(out.strip().splitlines()[-1])
    assert line["correct"] is True, err[-3000:]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert "mfu.train" in line["metrics"]
    assert line["device"]["count"] == (2 if cell == "tiny.dp.train" else 1)


def test_lower_precision_control_fails_the_dp_cells_limits():
    """The data-parallel cell's reference with its convs in float8 e4m3
    against the float32 one (image 64, base 8, a global batch of 8 in
    blocks of 2) fails at least one of the cell's limits."""
    from portbench.drivers import train_dp

    data, cfg = harness.cell_files(DP_CELL)
    cfg = {**cfg, **tiny.TINY}
    small = {**data, "params": {**data["params"], **tiny.PARAMS[
        "tiny.s2w.train"], "frames_a": 9, "batch_size": 8}}
    with tempfile.TemporaryDirectory() as d:
        run = train_dp.Cell(small, cfg, 13, "cpu", Path(d), lambda *a: None)
        run.dataset = run._dataset()
        n = len(run.dataset)
        run.check_indices = [[(8 * e + j) % n for j in range(8)]
                             for e in range(3)]
        ref = run.reference()
        numbers = check.training_numbers(run.reference(Precision("fp8")),
                                         ref)
    assert all(math.isfinite(v) for v in numbers.values()), numbers
    ok, rows = check.verdict(numbers, data["limits"])
    assert not ok, rows
