"""The port's data tools (vae_cyclegan_tpu_torch/data/tools.py) and batch-grid
demo (data/__main__.py) against the JAX package's, on a local scene ZIP
built as tests/test_tools.py builds it: no network. Every file either
package writes from the same inputs is byte for byte the other's.
"""

import runpy
import sys
import zipfile
from pathlib import Path

import h5py
import numpy as np
import pandas as pd
import pytest
from PIL import Image

from vae_cyclegan_tpu.data import tools as jax_tools
from vae_cyclegan_tpu_torch.data import tools


@pytest.fixture(scope="module")
def scene_zip_dir(tmp_path_factory):
    """ai_001_001.zip with the real Hypersim internal layout."""
    root = tmp_path_factory.mktemp("zips")
    tmp = tmp_path_factory.mktemp("scene_src")
    rng = np.random.RandomState(0)
    scene = "ai_001_001"
    img_dir = tmp / scene / "images"
    prev = img_dir / "scene_cam_00_final_preview"
    geom = img_dir / "scene_cam_00_geometry_hdf5"
    prev.mkdir(parents=True)
    geom.mkdir(parents=True)
    for frame in (0, 1):
        Image.fromarray((rng.rand(24, 32, 3) * 255).astype(np.uint8)).save(
            prev / f"frame.{frame:04d}.tonemap.jpg")
        for mod_file, data in [
            ("depth_meters.hdf5", rng.rand(24, 32).astype(np.float32) * 10),
            ("normal_cam.hdf5", rng.rand(24, 32, 3).astype(np.float32) * 2 - 1),
            ("semantic.hdf5", rng.randint(0, 20, (24, 32)).astype(np.int16)),
        ]:
            with h5py.File(geom / f"frame.{frame:04d}.{mod_file}", "w") as hf:
                hf.create_dataset("dataset", data=data)
    with zipfile.ZipFile(root / f"{scene}.zip", "w") as zf:
        for p in sorted(tmp.rglob("*")):
            if p.is_file():
                zf.write(p, p.relative_to(tmp))
    return root


def _files(root: Path) -> dict:
    return {p.relative_to(root): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def _same_tree(a: Path, b: Path) -> None:
    fa, fb = _files(a), _files(b)
    assert fa.keys() == fb.keys() and fa
    for k in fa:
        assert fa[k] == fb[k], k


def test_render_matches_jax():
    rng = np.random.RandomState(0)
    cases = [("depth", rng.rand(16, 16).astype(np.float32) * 5),
             ("normal", rng.rand(16, 16, 3).astype(np.float32) * 2 - 1),
             ("semantic", np.arange(256).reshape(16, 16).astype(np.int32)),
             ("position", rng.rand(8, 8, 3).astype(np.float32)),
             ("depth", np.full((8, 8), np.inf, np.float32))]
    for mod, data in cases:
        got, want = tools.render(mod, data), jax_tools.render(mod, data)
        assert got.dtype == want.dtype == np.uint8
        np.testing.assert_array_equal(got, want)


def test_export_frame_matches_jax(scene_zip_dir, tmp_path):
    ref = ("ai_001_001", "cam_00", 0)
    mods = ["color", "depth", "normal", "semantic"]
    for side, mod in (("port", tools), ("jax", jax_tools)):
        with mod.SceneArchive.open("ai_001_001", str(scene_zip_dir)) as ar:
            assert ar.has(mod.FrameRef(*ref), "depth")
            assert not ar.has(mod.FrameRef(*ref), "position")
            n = mod.export_frame(ar, mod.FrameRef(*ref), mods,
                                 tmp_path / side, "ai_001_001_living_room")
        assert n == 4
    _same_tree(tmp_path / "port", tmp_path / "jax")


def _metadata_repo(tmp_path):
    repo = tmp_path / "ml-hypersim"
    analysis = repo / "evermotion_dataset" / "analysis"
    analysis.mkdir(parents=True)
    pd.DataFrame({
        "scene_name": ["ai_001_001"] * 2,
        "camera_name": ["cam_00"] * 2,
        "frame_id": [0, 1],
        "included_in_public_release": [True, True],
    }).to_csv(analysis / "metadata_images.csv", index=False)
    pd.DataFrame({
        "Animation": ["ai_001_001_cam_00"], "Scene type": ["living room"],
    }).to_csv(analysis / "metadata_camera_trajectories.csv", index=False)
    return repo


def test_cli_subcommands_match_jax(scene_zip_dir, tmp_path):
    """sample, show and cache through each package's main: the same files,
    byte for byte; an unknown modality exits 1 on both sides."""
    repo = _metadata_repo(tmp_path)
    for side, mod in (("port", tools), ("jax", jax_tools)):
        out = tmp_path / side
        assert mod.main([
            "sample", "--num_images", "2", "--modalities", "depth", "color",
            "--output_dir", str(out / "sampled"), "--repo_path", str(repo),
            "--base_url", str(scene_zip_dir)]) == 0
        assert mod.main(["show", "--dataset", str(out / "sampled"),
                         "--output", str(out / "viz")]) == 0
        assert mod.main(["cache", "--root", str(out / "sampled"),
                         "--out", str(tmp_path / f"{side}.cache")]) == 0
        assert mod.main([
            "sample", "--num_images", "1", "--modalities", "nope",
            "--repo_path", str(repo), "--base_url", str(scene_zip_dir)]) == 1
    assert len(list((tmp_path / "port" / "sampled").rglob("*.png"))) == 4
    assert (tmp_path / "port" / "viz" /
            "modalities_grid_ai_001_001_living_room.png").exists()
    _same_tree(tmp_path / "port", tmp_path / "jax")
    # the caches index the same images (their keys are absolute paths)
    assert (tmp_path / "port.cache").read_bytes() == \
        (tmp_path / "jax.cache").read_bytes()


def test_batch_grids_match_jax(tmp_path, monkeypatch):
    """python -m vae_cyclegan_tpu_torch.data against python -m
    vae_cyclegan_tpu.data on the same tree: the same five PNG grids."""
    rng = np.random.RandomState(0)
    for scene in ("ai_001_001_indoor", "ai_001_002_outdoor"):
        d = tmp_path / "hypersim" / scene / "cam_00"
        d.mkdir(parents=True)
        for frame in range(2):
            for mod in ("depth", "normal"):
                arr = (rng.rand(40, 56, 3) * 255).astype(np.uint8)
                Image.fromarray(arr).save(d / f"frame_{frame:04d}_{mod}.png")
    for side, pkg in (("port", "vae_cyclegan_tpu_torch.data"),
                      ("jax", "vae_cyclegan_tpu.data")):
        monkeypatch.setattr(sys, "argv", [
            "demo", str(tmp_path / "hypersim"), str(tmp_path / side)])
        with pytest.raises(SystemExit) as done:
            runpy.run_module(pkg, run_name="__main__", alter_sys=False)
        assert done.value.code == 0
    _same_tree(tmp_path / "port", tmp_path / "jax")
    assert len(_files(tmp_path / "port")) == 5
