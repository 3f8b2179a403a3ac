"""The harness on the CPU: its files and names keep to the contract, a cell
and a metric added as new files are picked up without an edit, a run
imports no JAX module, each driver's last line has the contract's keys, and
a planted fault or the lower-precision control comes out not correct."""

import json
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from portbench import check, harness
from portbench.tests import tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}
BENCH = harness.benchmark()


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return tiny.make_tree(tmp_path_factory.mktemp("tree"))


def _last(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


def test_benchmark_keys_names_and_units():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [w["name"] for w in BENCH["workloads"]]
    names += [c["name"] for c in BENCH["configs"]]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in BENCH["workloads"]]:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_file_loads(cell):
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    data, cfg = harness.cell_files(cell)
    assert {k: data[k] for k in entry} == entry
    assert cfg["name"] == entry["config"] and cfg["reduced"] == []
    assert data["limits"] and all(v > 0 for v in data["limits"].values())
    e2e = harness.metrics_of(cell, "end_to_end")
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
    assert harness.metrics_of(cell, "per_layer")


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_every_metric_has_its_reader(metric):
    from portbench.metrics import reader

    assert callable(reader(metric))


#: a reference family for the program's VAE architecture, added as a file
ADDED_FAMILY = """
from portbench.reference.steps import Family, kl, l1


class VAE(Family):
    gen_keys = ("G",)

    def __init__(self, cfg, *a, **k):
        super().__init__(cfg, *a, **k)
        # one network's checkpoint is the network's own, with no prefix
        self.G = self.nets = self.nets["G"]

    def generator_loss(self, x, y, generator, parts):
        Gx, mu, logvar = self.G(x, generator)
        parts.update(loss_trans=l1(Gx, y), loss_kl=kl(mu, logvar))
        return parts["loss_trans"] + self.lam["kl"] * parts["loss_kl"], None


FAMILY = VAE
"""
#: a dataset added as two files: seeded noise pairs, flipped by the
#: sample's stream, on the program's side and worked out again on the
#: reference's
ADDED_DATASET = """
import numpy as np


class Pairs:
    def __init__(self, seed, n, size):
        self.seed, self.n, self.size = seed, n, size

    def __len__(self):
        return self.n

    def get(self, idx, rng):
        return pairs(self.seed, idx, rng, self.size)


def pairs(seed, idx, rng, size):
    a = np.random.RandomState(seed % 2 ** 31 + idx).randint(
        0, 256, (2, size, size, 3)).astype(np.uint8)
    if rng.random() < 0.5:
        a = a[:, :, ::-1]
    return {"x": np.ascontiguousarray(a[0]), "y": np.ascontiguousarray(a[1])}


def make(root, p, cfg, seed, device):
    return Pairs(seed, p["samples"], cfg["image_size"]), seed
"""
ADDED_REFERENCE_DATASET = """
import numpy as np
import torch

from portbench.datasets.noise_pairs import pairs


def batch(files, picks, p, cfg, device):
    items = [pairs(files, i, rng, cfg["image_size"]) for i, rng in picks]
    return tuple(torch.from_numpy(np.stack([it[k] for it in items])).to(
        device).permute(0, 3, 1, 2).float() / 255.0 for k in ("x", "y"))
"""


def test_new_cell_and_metric_files_are_picked_up(tree, tmp_path):
    """A cell, a configuration of another architecture with its reference
    family, a dataset and a per-layer metric, each added as new files and
    entries in BENCHMARK.json, run and come out correct without an edit to
    any file of the harness."""
    new = tiny.make_tree(tmp_path)
    pb = new / "portbench"
    (pb / "metrics" / "dummy_count.train.py").write_text(
        "def read(ctx):\n    return 42.0\n")
    (pb / "reference" / "families" / "vae.py").write_text(ADDED_FAMILY)
    (pb / "datasets" / "noise_pairs.py").write_text(ADDED_DATASET)
    (pb / "reference" / "datasets" / "noise_pairs.py").write_text(
        ADDED_REFERENCE_DATASET)
    cfg = json.loads((pb / "configs" / "tiny-vaegan-256.json").read_text())
    cfg.update(name="tiny-vae", architecture="vae")
    (pb / "configs" / "tiny-vae.json").write_text(json.dumps(cfg))
    cell = json.loads((pb / "workloads/tiny.s2w.train.json").read_text())
    cell.update(name="added.cell", config="tiny-vae",
                params={"dataset": "noise_pairs", "samples": 7,
                        "batch_size": 2, "num_workers": 2, "trace_after": 1,
                        "trace_steps": 1},
                limits={"g_loss_step1": 1e-4, "g_loss_step2": 1e-3})
    (pb / "workloads/added.cell.json").write_text(json.dumps(cell))
    bench = json.loads((new / "BENCHMARK.json").read_text())
    bench["configs"].append({**bench["configs"][0], "name": "tiny-vae",
                             "file": "portbench/configs/tiny-vae.json"})
    bench["workloads"].append({"name": "added.cell", "config": "tiny-vae",
                               "traffic": "added", "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "dummy_count.train", "unit": "count",
                               "better": "lower", "source": "program_counter",
                               "layer": "data", "moves": "train_images_per_s",
                               "workloads": ["added.cell"]})
    for m in bench["end_to_end"]:
        if m["name"] == "train_images_per_s":
            m["workloads"].append("added.cell")
    (new / "BENCHMARK.json").write_text(json.dumps(bench))
    rc, out, err = tiny.run(new, ["--workload", "added.cell", "--seed", "5",
                                  "--seconds", "1", "--trace", "1"])
    assert rc == 0, err[-3000:]
    line = _last(out)
    assert line["metrics"]["dummy_count.train"]["value"] == 42.0
    assert line["correct"] is True, err[-3000:]


@pytest.mark.parametrize("cell", list(tiny.PARAMS))
def test_tiny_run_prints_the_contract_line(tree, cell):
    rc, out, err = tiny.run(tree, ["--workload", cell, "--seed",
                                   str(2 ** 31 + 7), "--seconds", "1",
                                   "--trace", "0"])
    assert rc == 0, err[-3000:]
    line = _last(out)
    assert set(line) == KEYS and list(line)[-1] == "checks"
    assert line["correct"] is True, err[-3000:]
    assert line["attempted"] > 0 and line["failed"] == 0
    names = {m["name"] for m in json.loads(
        (tree / "BENCHMARK.json").read_text())["end_to_end"]
             if cell in m.get("workloads", [cell])}
    assert set(line["metrics"]) == names
    assert err.strip().splitlines()[-1].startswith("check ")


def test_run_loads_no_jax(tree):
    code = ("import sys\nfrom portbench import run\n"
            "run.main(['--workload', 'tiny.serve', '--seed', '3', "
            "'--seconds', '1'], device='cpu')\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    env = dict(tiny.os.environ, PYTHONPATH=f"{tree}:{tiny.REPO}")
    out = subprocess.run([sys.executable, "-c", code], cwd=tree, env=env,
                         capture_output=True, text=True, check=True).stdout
    loaded = set(json.loads(out.strip().splitlines()[-1].replace("'", '"')))
    assert not loaded & set(harness.FORBIDDEN)
    assert "vae_cyclegan_tpu_torch" in loaded


def test_no_card_no_result(tmp_path):
    """Without CUDA the command exits non-zero and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    p = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                        BENCH["workloads"][0]["name"], "--seed", "1",
                        "--seconds", "1"], cwd=harness.ROOT,
                       capture_output=True, text=True)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_checkout_without_the_program_fails(tmp_path):
    """A directory that holds only BENCHMARK.json and the harness cannot
    run: no result, non-zero exit."""
    import shutil

    shutil.copytree(harness.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    code = ("import sys\nfrom portbench import run\nsys.exit(run.main(["
            f"'--workload', {BENCH['workloads'][0]['name']!r}, '--seed', '1',"
            " '--seconds', '1'], device='cpu'))\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                       env=dict(tiny.os.environ, PYTHONPATH=str(tmp_path)),
                       capture_output=True, text=True)
    assert p.returncode != 0 and p.stdout.strip() == ""


# -- planted faults: each must come out not correct ---------------------------

UNCHANGED = """
from vae_cyclegan_tpu_torch.models.tasks import base
base.Task._finite_update = staticmethod(
    lambda opt, loss, params, grads, dump=None: 0.0)
"""
HALF_BATCH = """
from vae_cyclegan_tpu_torch import engine
_prep = engine.Engine._prep
engine.Engine._prep = lambda self, b: {k: v[: max(1, len(v) // 2)]
                                       for k, v in _prep(self, b).items()}
"""
RECON_WEIGHT = """
from vae_cyclegan_tpu_torch import config
_Loss = config.LossConfig
config.LossConfig = lambda kl, gan, ident, cycle, recon: _Loss(
    kl, gan, ident, 1.1 * cycle, 1.1 * recon)
"""
GEN_OUTPUT = """
from vae_cyclegan_tpu_torch.models import networks
_fwd = networks.VariationalAutoencoderNet.forward
def _scaled(self, *a, **k):
    out = _fwd(self, *a, **k)
    return (out[0] * 1.01, *out[1:])
networks.VariationalAutoencoderNet.forward = _scaled
"""
ANSWER_ALTERED = """
from vae_cyclegan_tpu_torch.models.tasks import cyclegan
_gen = cyclegan._CycleGANBase.generate
cyclegan._CycleGANBase.generate = lambda self, *a, **k: _gen(self, *a, **k) * 1.01
"""


@pytest.mark.parametrize("cell,fault", [
    ("tiny.s2w.train", UNCHANGED), ("tiny.s2w.train", HALF_BATCH),
    ("tiny.s2w.train", RECON_WEIGHT), ("tiny.s2w.train", GEN_OUTPUT),
    ("tiny.hypersim.train", UNCHANGED), ("tiny.hypersim.train", HALF_BATCH),
    ("tiny.hypersim.train", RECON_WEIGHT),
    ("tiny.hypersim.train", GEN_OUTPUT),
    ("tiny.serve", ANSWER_ALTERED)],
    ids=["s2w-unchanged", "s2w-half-batch", "s2w-recon-weight",
         "s2w-gen-output", "hypersim-unchanged", "hypersim-half-batch",
         "hypersim-recon-weight", "hypersim-gen-output",
         "serve-answer-altered"])
def test_planted_fault_is_not_correct(tree, cell, fault):
    rc, out, err = tiny.run(tree, ["--workload", cell, "--seed", "9",
                                   "--seconds", "1"], code=fault)
    assert rc == 0, err[-3000:]
    assert _last(out)["correct"] is False


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_lower_precision_control_fails_the_cells_limits(cell):
    """The reference with its convs in float8 e4m3, put in the program's
    place against the float32 reference (at a size a CPU test holds: image
    64, base 8, batch 2), fails at least one of the cell's own limits."""
    import tempfile

    from portbench.reference.nets import Precision

    data, cfg = harness.cell_files(cell)
    cfg = {**cfg, **tiny.TINY}
    kind = data["driver"]
    small = {**data, "params": {**data["params"], **tiny.PARAMS[
        {"train": "tiny.hypersim.train" if data["params"].get("dataset")
         == "hypersim" else "tiny.s2w.train", "serve": "tiny.serve"}[kind]]}}
    import importlib

    driver = importlib.import_module(f"portbench.drivers.{kind}")
    with tempfile.TemporaryDirectory() as d:
        run = driver.Cell(small, cfg, 13, "cpu", Path(d), lambda *a: None)
        if kind == "train":
            run.dataset = run._dataset()
            n, b = len(run.dataset), small["params"]["batch_size"]
            run.check_indices = [[(b * e + j) % n for j in range(b)]
                                 for e in range(3)]
            ref = run.reference()
            numbers = check.training_numbers(run.reference(Precision("fp8")),
                                             ref)
        else:
            run.setup()
            run.window(1.0)
            ref = run.reference()
            run.kept = {i: a.numpy() for i, a in
                        run.reference(Precision("fp8")).items()}
            numbers = run.numbers(ref)
    ok, rows = check.verdict(numbers, data["limits"])
    assert not ok, rows


@pytest.mark.gpu
def test_serving_cell_on_the_card():
    """On a machine with the card: a short run of the serving cell comes
    out correct with every end-to-end metric (python -m pytest
    portbench/tests -m gpu there)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cell = "cyclevaegan.s2w.serve.b16"
    p = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                        cell, "--seed", "77", "--seconds", "3"],
                       cwd=harness.ROOT, capture_output=True, text=True,
                       timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    line = _last(p.stdout)
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
    assert {m["name"] for m in harness.metrics_of(cell, "end_to_end")} == set(
        line["metrics"])
