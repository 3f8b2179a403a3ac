"""The port's drivers, ``python -m vae_cyclegan_tpu_torch.train`` and
``.test``, against the JAX package's train.py and test.py.

* Flag surface: every flag of JAX's train parser and test.py's parser, with
  the same defaults; the flags that queue 1's items 7c and 10 leave refused
  raise with the item named; the card is the default device.
* Data parallelism: ``--num_devices 2`` on the CPU (two gloo ranks) trains
  an epoch with the primary rank alone writing the run directory;
  ``--multihost`` without the launcher's environment raises, naming what is
  missing, before writing anything (tests/test_torch_multihost.py runs it
  from a torchrun-style environment).
* A fresh run on the CPU (2 epochs of 2 batches): train.py's run-directory
  layout and TensorBoard tags, and ``args.json`` equal to what JAX's driver
  writes for the same argv.
* The modality checks of tests/test_cli.py; SIGTERM in a subprocess leaves
  a resumable ``checkpoint_preempt/``.
* Evaluation: ``python -m vae_cyclegan_tpu_torch.test`` on that run writes
  ``summary.json`` with the JAX driver's keys; the legacy-keys and filter
  cases of tests/test_cli.py.
* ``slow``: both drivers on the same tree, layouts, args and tag sets
  compared.

Small size: image 32, base 8, latent 8, batch 2.
"""

import ast
import importlib.util
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from vae_cyclegan_tpu_torch import test as port_test
from vae_cyclegan_tpu_torch import train as port_train
from vae_cyclegan_tpu_torch.utils import checkpoint_exists

REPO = Path(__file__).resolve().parents[1]


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_train():
    return _load("jax_train_driver", REPO / "train.py")


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    """8 paired depth/normal samples of 40x56 frames: 6 train, 2 test."""
    root = tmp_path_factory.mktemp("driver_data")
    rng = np.random.RandomState(0)
    for scene in ("ai_001_001_indoor", "ai_001_002_outdoor"):
        d = root / "hypersim" / scene / "cam_00"
        d.mkdir(parents=True)
        for frame in range(4):
            for mod in ("depth", "normal"):
                arr = (rng.rand(40, 56, 3) * 255).astype(np.uint8)
                Image.fromarray(arr).save(d / f"frame_{frame:04d}_{mod}.png")
    return root


def _flags(parser):
    """{option string: default} of every optional argument."""
    return {s: a.default for a in parser._actions for s in a.option_strings
            if s.startswith("--") and s != "--help"}


def _jax_test_flags():
    """{option string: default} of the add_argument calls in JAX's test.py
    (its parser is built inside its __main__ block)."""
    out = {}
    for node in ast.walk(ast.parse((REPO / "test.py").read_text())):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "add_argument"):
            kw = {k.arg: k.value for k in node.keywords}
            default = (ast.literal_eval(kw["default"]) if "default" in kw
                       else (False if "action" in kw else None))
            out[ast.literal_eval(node.args[0])] = default
    return out


def test_train_flag_surface_matches_jax(jax_train):
    got, want = _flags(port_train.build_parser()), _flags(
        jax_train.build_parser())
    assert got == want


def test_test_flag_surface_matches_jax():
    want = _jax_test_flags()
    assert "--runs_dir" in want and "--fid_weights" in want
    assert _flags(port_test.build_parser()) == want


@pytest.mark.parametrize("flags,item", [(["--no_pallas"], "item 10")])
def test_train_refuses_unported_flags(flags, item, data_root, tmp_path):
    args = port_train.build_parser().parse_args(
        ["--platform", "cpu", "--architecture", "cyclevaegan", "--data_dir",
         str(data_root), "--output_dir", str(tmp_path), *flags])
    with pytest.raises(NotImplementedError, match=item):
        port_train.main(args)
    assert not list(tmp_path.iterdir())  # refused before the run directory


def test_train_num_devices_2_on_the_cpu(data_root, tmp_path):
    """--platform cpu --num_devices 2: two spawned gloo ranks train one
    epoch of two global batches (one sample a rank) and validate; the run
    directory is the one-process run's layout, written once (one
    TensorBoard event file: the other rank opens no writer)."""
    argv = _argv(data_root, tmp_path, 1, "vae", "--num_devices", "2")
    run_dir = port_train.main(port_train.build_parser().parse_args(argv))
    assert [p.name for p in tmp_path.iterdir()] == [run_dir.name]
    assert sorted(p.name for p in run_dir.iterdir()) == [
        "args.json", "best_model", "checkpoint_epoch_1", "tensorboard"]
    assert len(list((run_dir / "tensorboard").glob("events.out.*"))) == 1
    assert json.loads((run_dir / "args.json").read_text())["num_devices"] == 2
    meta = json.loads((run_dir / "checkpoint_epoch_1" / "meta.json")
                      .read_text())
    assert meta["epoch"] == 0 and np.isfinite(meta["loss"])
    scalars, _ = _tags(run_dir)
    assert scalars["Loss/train"] == [0] and scalars["Loss/test"] == [0]


def test_train_spatial_2_on_the_cpu(data_root, tmp_path):
    """--platform cpu --num_devices 2 --spatial 2: two spawned gloo ranks
    form one spatial group (each holds 16 of the 32 rows of every image),
    train one epoch of two global batches and validate; the run directory
    is the one-process run's layout, written once, with finite losses."""
    argv = _argv(data_root, tmp_path, 1, "vae", "--num_devices", "2",
                 "--spatial", "2")
    run_dir = port_train.main(port_train.build_parser().parse_args(argv))
    assert [p.name for p in tmp_path.iterdir()] == [run_dir.name]
    assert sorted(p.name for p in run_dir.iterdir()) == [
        "args.json", "best_model", "checkpoint_epoch_1", "tensorboard"]
    assert len(list((run_dir / "tensorboard").glob("events.out.*"))) == 1
    assert json.loads((run_dir / "args.json").read_text())["spatial"] == 2
    meta = json.loads((run_dir / "checkpoint_epoch_1" / "meta.json")
                      .read_text())
    assert meta["epoch"] == 0 and np.isfinite(meta["loss"])
    scalars, _ = _tags(run_dir)
    assert scalars["Loss/train"] == [0] and scalars["Loss/test"] == [0]


@pytest.mark.parametrize("flags,error,match", [
    (["--num_devices", "2", "--spatial", "3"], ValueError, "does not divide"),
    (["--spatial", "2"], ValueError, "does not divide"),
    (["--multihost", "--spatial", "2"], NotImplementedError, "single-host")])
def test_train_refuses_a_spatial_size(flags, error, match, data_root,
                                      tmp_path):
    """JAX's refusals (``make_mesh``, ``shard_batch``): a spatial size that
    does not divide the ranks (one rank on the CPU by default), and spatial
    sharding across hosts; raised before the run directory."""
    args = port_train.build_parser().parse_args(
        _argv(data_root, tmp_path, 1, "vae", *flags))
    with pytest.raises(error, match=match):
        port_train.main(args)
    assert not list(tmp_path.iterdir())


def test_train_multihost_needs_the_launcher_environment(data_root, tmp_path,
                                                         monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    args = port_train.build_parser().parse_args(
        _argv(data_root, tmp_path, 1, "vae", "--multihost"))
    with pytest.raises(RuntimeError, match="torchrun"):
        port_train.main(args)
    assert not list(tmp_path.iterdir())


def test_drivers_run_on_the_card_by_default(data_root, tmp_path):
    """No --platform: the card; this machine has none, so both raise. An
    unknown platform raises on any machine."""
    parse = port_train.build_parser().parse_args
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port_train.main(parse(["--architecture", "cyclevaegan",
                                   "--data_dir", str(data_root),
                                   "--output_dir", str(tmp_path)]))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port_test.main(port_test.build_parser().parse_args(
                ["--runs_dir", str(tmp_path)]))
    with pytest.raises(ValueError, match="'cuda'"):
        port_train.main(parse(["--platform", "tpu", "--architecture",
                               "cyclevaegan", "--data_dir", str(data_root),
                               "--output_dir", str(tmp_path)]))


def _argv(data_root, out_dir, epochs, arch="vae", *extra):
    return ["--platform", "cpu", "--architecture", arch, "--paired",
            "--dataset", "hypersim", "--data_dir", str(data_root),
            "--source_modality", "depth", "--target_modality",
            "depth" if arch in ("autoencoder", "vae") else "normal",
            "--image_size", "32", "--base_width", "8", "--latent_dim", "8",
            "--batch_size", "2", "--epochs", str(epochs),
            "--test_split", "0.5", "--output_dir", str(out_dir),
            "--save_freq", "1", "--log_image_freq", "1", "--quiet",
            "--num_workers", "2", *extra]


def _tags(run_dir):
    from tensorboard.backend.event_processing.event_accumulator import (
        EventAccumulator,
    )

    ea = EventAccumulator(str(run_dir / "tensorboard"),
                          size_guidance={"scalars": 0, "images": 0})
    ea.Reload()
    return ({t: [e.step for e in ea.Scalars(t)]
             for t in ea.Tags()["scalars"]},
            {t: [e.step for e in ea.Images(t)] for t in ea.Tags()["images"]})


@pytest.fixture(scope="module")
def fresh_run(data_root, tmp_path_factory):
    """The port's vae, paired, 2 epochs of 2 batches on the CPU."""
    out = tmp_path_factory.mktemp("port_runs")
    argv = _argv(data_root, out, 2)
    return port_train.main(port_train.build_parser().parse_args(argv)), argv


def test_fresh_run_layout_and_tags(fresh_run, jax_train):
    run_dir, argv = fresh_run
    assert run_dir.name.startswith("vae_") and \
        run_dir.name.endswith("_depth_to_depth_hypersim")
    assert sorted(p.name for p in run_dir.iterdir()) == [
        "args.json", "best_model", "checkpoint_epoch_1", "checkpoint_epoch_2",
        "tensorboard"]
    for ck in ("best_model", "checkpoint_epoch_1", "checkpoint_epoch_2"):
        assert checkpoint_exists(run_dir / ck)
    meta = json.loads((run_dir / "checkpoint_epoch_2" / "meta.json").read_text())
    assert meta["epoch"] == 1 and np.isfinite(meta["loss"])
    scalars, images = _tags(run_dir)
    parts = {"G_loss", "loss_trans", "loss_kl"}
    assert set(scalars) == ({"Loss/train", "Loss/test"}
                            | {f"Loss_Components_train/{k}"
                               for k in parts | {"images_per_sec"}}
                            | {f"Loss_Components_test/{k}" for k in parts})
    assert all(steps == [0, 1] for steps in scalars.values())
    assert set(images) == {"depth/test_x", "depth/test_y", "depth/test_Gx"}
    # args.json: what JAX's driver writes for the same argv (its main fills
    # the modality defaults; both were given here)
    want = vars(jax_train.build_parser().parse_args(argv))
    assert json.loads((run_dir / "args.json").read_text()) == want


def test_train_rejects_mismatched_ae_modalities(data_root, tmp_path):
    args = port_train.build_parser().parse_args(
        _argv(data_root, tmp_path, 1))
    args.source_modality, args.target_modality = "depth", "normal"
    with pytest.raises(ValueError, match="same for Autoencoder/VAE"):
        port_train.main(args)


def test_pretrained_flags_are_checked(data_root, tmp_path):
    """Both Double* sources at once, and a source for the wrong family,
    raise as in JAX's driver."""
    parse = port_train.build_parser().parse_args
    args = parse(_argv(data_root, tmp_path, 1, "cycleae",
                       "--pretrained_doubleae", "a",
                       "--pretrained_doublevae", "b"))
    with pytest.raises(ValueError, match="both"):
        port_train.main(args)
    args = parse(_argv(data_root, tmp_path, 1, "cyclevae",
                       "--pretrained_doubleae", "a"))
    with pytest.raises(ValueError, match="pretrained_doubleae"):
        port_train.main(args)


def test_sigterm_saves_resumable_checkpoint(data_root, tmp_path):
    """SIGTERM mid-training: exit 0 and a checkpoint_preempt/ that --resume
    takes (re-running the interrupted epoch)."""
    out_dir = tmp_path / "runs"
    base = [sys.executable, "-m", "vae_cyclegan_tpu_torch.train"]
    argv = _argv(data_root, out_dir, 500, "autoencoder")
    argv[argv.index("--log_image_freq") + 1] = "1000"
    argv[argv.index("--save_freq") + 1] = "1000"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    proc = subprocess.Popen(base + argv, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, cwd=REPO,
                            env=env)
    deadline = time.time() + 300
    lines = []
    for line in proc.stdout:
        lines.append(line)
        if line.startswith("Epoch 2/"):
            break
        if time.time() > deadline:
            proc.kill()
            pytest.fail("training never reached epoch 2:\n" + "".join(lines))
    proc.send_signal(signal.SIGTERM)
    rest, _ = proc.communicate(timeout=300)
    out = "".join(lines) + rest
    assert proc.returncode == 0, out
    assert "Preemption checkpoint saved" in out
    (run_dir,) = out_dir.glob("autoencoder_*")
    ckpt = run_dir / "checkpoint_preempt"
    assert checkpoint_exists(ckpt), out
    meta = json.loads((ckpt / "meta.json").read_text())
    assert meta["epoch"] <= 0  # the interrupted epoch, less one

    argv = _argv(data_root, out_dir, 2, "autoencoder", "--resume", str(ckpt))
    done = subprocess.run(base + argv, capture_output=True, text=True,
                          timeout=300, cwd=REPO, env=env)
    assert done.returncode == 0, done.stdout + done.stderr
    assert "Training completed" in done.stdout


def _jax_summary_keys():
    """The keys of the summary dict literal in JAX's test.py."""
    for node in ast.walk(ast.parse((REPO / "test.py").read_text())):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(getattr(t, "id", None) == "summary"
                        for t in node.targets)):
            return {ast.literal_eval(k) for k in node.value.keys}
    raise AssertionError("no summary literal in test.py")


def test_eval_driver_on_the_run(fresh_run, data_root, tmp_path):
    run_dir, _ = fresh_run
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    done = subprocess.run(
        [sys.executable, "-m", "vae_cyclegan_tpu_torch.test", "--platform",
         "cpu", "--runs_dir", str(run_dir.parent), "--data_dir",
         str(data_root), "--output_dir", str(tmp_path), "--num_samples",
         "3", "--num_comparison_figures", "2"],
        capture_output=True, text=True, timeout=300, cwd=REPO, env=env)
    assert done.returncode == 0, done.stdout + done.stderr
    group = tmp_path / "hypersim" / "depth_to_depth"
    summary = json.loads((group / "summary.json").read_text(),
                         parse_constant=lambda c: (_ for _ in ()).throw(
                             ValueError(f"non-RFC JSON constant {c}")))
    assert set(summary) == _jax_summary_keys()
    assert summary["num_samples"] == 3 and summary["num_models"] == 1
    for key in ("l1_to_target", "psnr_to_target", "ssim_to_target"):
        (v,) = summary[key].values()
        assert np.isfinite(v)
    (entry,) = summary["models"]
    assert entry["architecture"] == "vae"
    assert entry["training_args"]["architecture"] == "vae"
    assert sorted(p.name for p in group.glob("comparison_*.png")) == [
        "comparison_sample_000.png", "comparison_sample_001.png"]
    assert [p.name for p in group.glob("grid_*.png")] == [
        f"grid_{run_dir.name}.png"]


def test_eval_driver_legacy_ab_batch_keys():
    """The port's eval path maps legacy 'A'/'B' batch keys as test.py's
    normalize_batch_keys does (reference test.py:301-303)."""
    a = np.zeros((1, 4, 4, 3), np.float32)
    b = np.ones((1, 4, 4, 3), np.float32)
    out = port_test.normalize_batch_keys({"A": a, "B": b})
    np.testing.assert_array_equal(out["x"], a)
    np.testing.assert_array_equal(out["y"], b)
    np.testing.assert_array_equal(
        port_test.normalize_batch_keys({"A": a})["y"], a)
    modern = {"x": a, "y": b}
    assert port_test.normalize_batch_keys(modern) is modern


def test_eval_driver_architecture_and_dataset_filters(monkeypatch):
    """--architectures / --dataset_filter route only matching runs into
    evaluation (reference test.py:706-711)."""
    fake_runs = [
        {"run_dir": Path(n), "name": n, "checkpoint": Path(n) / "best_model",
         "args": {"architecture": a, "dataset": d}}
        for n, a, d in [("r1", "vae", "hypersim"), ("r2", "aegan", "hypersim"),
                        ("r3", "vae", "maps")]
    ]
    monkeypatch.setattr(port_test, "discover_runs", lambda d: list(fake_runs))
    routed = []
    monkeypatch.setattr(
        port_test, "evaluate_model_group",
        lambda ds, group, args: routed.append(
            (ds, sorted(r["name"] for r in group))))

    def _args(**kw):
        base = {"runs_dir": ".", "architectures": None, "dataset_filter": None}
        base.update(kw)
        return type("A", (), base)()

    port_test.evaluate_models(_args(architectures=["vae"]))
    assert routed == [("hypersim", ["r1"]), ("maps", ["r3"])]
    routed.clear()
    port_test.evaluate_models(_args(dataset_filter="maps"))
    assert routed == [("maps", ["r3"])]
    routed.clear()
    port_test.evaluate_models(_args(architectures=["aegan"],
                                    dataset_filter="maps"))
    assert routed == []


@pytest.mark.slow  # both drivers' full runs, JAX's compiles included
def test_both_drivers_on_the_same_tree(data_root, tmp_path, jax_train):
    """JAX's train.py and test.py and the port's on the same tree and argv:
    the same run-directory entries, args.json, TensorBoard tag sets with
    their steps, and summary.json keys."""
    runs = {}
    for side in ("jax", "port"):
        argv = _argv(data_root, tmp_path / side, 2)
        if side == "jax":
            argv[:2] = ["--platform", "cpu", "--no_pallas"]
            runs[side] = jax_train.main(jax_train.build_parser().parse_args(
                argv))
        else:
            runs[side] = port_train.main(
                port_train.build_parser().parse_args(argv))
    jdir, pdir = runs["jax"], runs["port"]
    assert jdir.name == pdir.name
    assert sorted(p.name for p in jdir.iterdir()) == \
        sorted(p.name for p in pdir.iterdir())
    ja = json.loads((jdir / "args.json").read_text())
    pa = json.loads((pdir / "args.json").read_text())
    ja.pop("no_pallas"), pa.pop("no_pallas")
    ja.pop("output_dir"), pa.pop("output_dir")
    assert ja == pa
    assert _tags(jdir) == _tags(pdir)

    jax_test = _load("jax_eval_driver", REPO / "test.py")
    for side, mod in (("jax", jax_test), ("port", port_test)):
        args = type("A", (), {
            "runs_dir": str(tmp_path / side), "data_dir": str(data_root),
            "output_dir": str(tmp_path / f"eval_{side}"), "num_samples": 2,
            "platform": "cpu"})()
        mod.evaluate_models(args)
    group = Path("hypersim") / "depth_to_depth"
    js = json.loads((tmp_path / "eval_jax" / group / "summary.json")
                    .read_text())
    ps = json.loads((tmp_path / "eval_port" / group / "summary.json")
                    .read_text())
    assert set(js) == set(ps)
    assert sorted(p.name for p in (tmp_path / "eval_jax" / group).iterdir()) \
        == sorted(p.name for p in (tmp_path / "eval_port" / group).iterdir())
