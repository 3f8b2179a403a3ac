"""The port's data path (``vae_cyclegan_tpu_torch/data/``) against the JAX
package's data modules: the three dataset formats, the split, the loader,
the decoded-image cache and the native decoder give batches equal byte for
byte; the on-device augmentation matches JAX's ``device_augment`` within
atol 1e-5 (measured at most 3.0e-7); and the port's package imports with
Pillow blocked.

The on-disk fixture is tests/test_data.py's seeded tree: Hypersim (2 scenes
x 2 cameras x 3 frames x 3 modalities, 40x56 PNGs), maps (4 side-by-side
30x64 JPEGs) and summer2winter (3 + 5 32x32 JPEGs).
"""

import os
import random
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import vae_cyclegan_tpu.data as jdata
from vae_cyclegan_tpu.data import datasets as jdatasets
from vae_cyclegan_tpu.data import device_aug as jaug
from vae_cyclegan_tpu.data import native as jnative
import vae_cyclegan_tpu_torch.data as tdata
from vae_cyclegan_tpu_torch.data import datasets as tdatasets
from vae_cyclegan_tpu_torch.data import device_aug as taug
from vae_cyclegan_tpu_torch.data import native as tnative
import torch_loader_cases

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AUG_ATOL = 1e-5


@pytest.fixture(scope="module")
def dataset_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("dataset")
    rng = np.random.RandomState(0)
    for scene in ["ai_001_001_indoor", "ai_002_001_outdoor"]:
        for cam in ["cam_00", "cam_01"]:
            d = root / "hypersim" / scene / cam
            d.mkdir(parents=True)
            for frame in range(3):
                for mod in ["depth", "normal", "color"]:
                    arr = (rng.rand(40, 56, 3) * 255).astype(np.uint8)
                    Image.fromarray(arr).save(
                        d / f"frame_{frame:04d}_{mod}.png")
    (root / "maps" / "train").mkdir(parents=True)
    for i in range(4):
        arr = (rng.rand(30, 64, 3) * 255).astype(np.uint8)
        Image.fromarray(arr).save(root / "maps" / "train" / f"{i}.jpg")
    for sub in ["trainA", "trainB"]:
        (root / "summer2winter" / sub).mkdir(parents=True)
        for i in range(3 if sub == "trainA" else 5):
            arr = (rng.rand(32, 32, 3) * 255).astype(np.uint8)
            Image.fromarray(arr).save(root / "summer2winter" / sub / f"{i}.jpg")
    return root


def assert_items_equal(got: dict, want: dict) -> None:
    """The same keys, and per key the same dtype, shape and bytes."""
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].shape == want[k].shape, k
        assert got[k].tobytes() == want[k].tobytes(), k


HYPERSIM_CASES = {
    "paired": dict(modalities=["depth", "normal"], paired_mode=True,
                   augment=dict(out_size=24, hflip_p=0.5, vflip_p=0.5)),
    "single_modality": dict(modalities=["depth"], paired_mode=True,
                            augment=dict(out_size=16)),
    "unpaired": dict(modalities=["depth", "normal"], paired_mode=False,
                     augment=dict(out_size=24, hflip_p=0.5)),
    "unpaired_uint8": dict(modalities=["depth", "normal"], paired_mode=False,
                           augment=dict(out_size=20, vflip_p=0.5),
                           uint8_output=True),
    "eval_resize": dict(modalities=["depth", "normal"], paired_mode=True,
                        augment=dict(out_size=24, random_crop=False,
                                     hflip_p=0.5)),
    "no_augment": dict(modalities=["depth", "normal"], paired_mode=True),
    "color_jitter": dict(modalities=["depth", "color"], paired_mode=True,
                         augment=dict(out_size=24), jitter=True),
    "raw_paired": dict(modalities=["depth", "normal"], paired_mode=True,
                       augment=dict(out_size=16, hflip_p=0.5, vflip_p=0.3),
                       raw_mode=True),
    "raw_unpaired": dict(modalities=["depth", "normal"], paired_mode=False,
                         augment=dict(out_size=16, hflip_p=0.5, vflip_p=0.3),
                         raw_mode=True),
    "raw_eval": dict(modalities=["depth", "normal"], paired_mode=False,
                     augment=dict(out_size=16, random_crop=False),
                     raw_mode=True),
}


def _hypersim(mod, root, case):
    kw = dict(case)
    aug = kw.pop("augment", None)
    jitter = kw.pop("jitter", False)
    return mod.HypersimDataset(
        str(root / "hypersim"), kw.pop("modalities"),
        augment=mod.AugmentConfig(**aug) if aug else None,
        color_jitter=mod.ColorJitterConfig(0.5, 0.5, 0.5, 0.3) if jitter
        else None, **kw)


@pytest.mark.parametrize("case", sorted(HYPERSIM_CASES))
def test_hypersim_matches_jax(dataset_root, case):
    """Every sample of the port's HypersimDataset equals the JAX package's,
    byte for byte, under the same rng: paired, unpaired, uint8, the eval
    resize, color jitter and the raw wire format (frames + aug vectors)."""
    port, ref = (_hypersim(m, dataset_root, HYPERSIM_CASES[case])
                 for m in (tdata, jdata))
    assert len(port) == len(ref) == 12
    assert port.get_unique_scenes() == ref.get_unique_scenes()
    for i in range(len(ref)):
        assert_items_equal(port.get(i, random.Random(100 + i)),
                           ref.get(i, random.Random(100 + i)))


@pytest.mark.parametrize("fmt", ["maps", "summer2winter",
                                 "summer2winter_jitter"])
def test_other_formats_match_jax(dataset_root, fmt):
    """The maps (halves of one file, shared params) and summer2winter
    (random B partner, independent draws, optional jitter) datasets equal
    the JAX package's, byte for byte."""
    def make(mod):
        aug = mod.AugmentConfig(out_size=16, hflip_p=0.5)
        if fmt == "maps":
            return mod.SatelliteMapDataset(str(dataset_root / "maps"),
                                           "train", augment=aug)
        return mod.Summer2WinterDataset(
            str(dataset_root / "summer2winter"), "train", augment=aug,
            color_jitter=mod.ColorJitterConfig() if fmt.endswith("jitter")
            else None, uint8_output=fmt == "summer2winter")

    port, ref = make(tdata), make(jdata)
    assert len(port) == len(ref)
    for i in range(len(ref)):
        assert_items_equal(port.get(i, random.Random(i)),
                           ref.get(i, random.Random(i)))


def test_split_and_filters_match_jax(dataset_root):
    """split_dataset's seeded split, Subset and the scene filters keep the
    JAX package's indices."""
    port, ref = (m.HypersimDataset(str(dataset_root / "hypersim"), ["depth"])
                 for m in (tdata, jdata))
    for frac, seed in ((0.25, 42), (0.5, 3)):
        (ptr, pte), (jtr, jte) = (tdata.split_dataset(port, frac, seed),
                                  jdata.split_dataset(ref, frac, seed))
        assert (ptr.indices, pte.indices) == (jtr.indices, jte.indices)
        assert_items_equal(pte.get(0, random.Random(1)),
                           jte.get(0, random.Random(1)))
    assert ([s["frame_id"] for s in port.filter_by_scene_type(["indoor"])
             .samples] == [s["frame_id"] for s in
                           ref.filter_by_scene_type(["indoor"]).samples])
    assert (len(port.filter_by_scene(["ai_002_001"]))
            == len(ref.filter_by_scene(["ai_002_001"])) == 6)


LOADER_CASES = {
    "shuffled": dict(batch_size=5, shuffle=True, seed=7, num_workers=2),
    "drop_last": dict(batch_size=5, shuffle=True, seed=1, drop_last=True),
    "ordered": dict(batch_size=4, shuffle=False, num_workers=3),
    "shard0": dict(batch_size=4, shuffle=True, seed=3, shard_index=0,
                   shard_count=2),
    "shard1": dict(batch_size=4, shuffle=True, seed=3, shard_index=1,
                   shard_count=2),
    "processes": dict(batch_size=6, shuffle=True, seed=5, num_workers=2,
                      use_processes=True),
}


@pytest.mark.parametrize("case", sorted(LOADER_CASES))
def test_loader_matches_jax(dataset_root, case):
    """Two epochs of the port's DataLoader (per-(epoch, position) seeding,
    drop_last, shard slices, the spawned process pool) equal the JAX
    package's, batch for batch and byte for byte."""
    kw = LOADER_CASES[case]
    loaders = []
    for mod in (tdata, jdata):
        ds = mod.HypersimDataset(
            str(dataset_root / "hypersim"), ["depth", "normal"],
            augment=mod.AugmentConfig(out_size=16, hflip_p=0.5),
            paired_mode=False, uint8_output=True)
        # the reference loads in threads: the JAX package's pool forks, and
        # this process has threads
        loaders.append(mod.DataLoader(ds, **dict(
            kw, use_processes=mod is tdata and kw.get("use_processes",
                                                      False))))
    try:
        for epoch in range(2):
            got, want = (list(ld) for ld in loaders)
            assert len(got) == len(want) > 0
            for a, b in zip(got, want):
                assert_items_equal(a, b)
            assert loaders[0].epoch == loaders[1].epoch == epoch + 1
    finally:
        for ld in loaders:
            ld.close()


@pytest.fixture(scope="module")
def s2w_epochal(tmp_path_factory):
    """A host-augmented Summer2Winter dataset (26 + 14 48x48 JPEGs, flip,
    crop to 32, colour jitter, uint8) behind ``Epochal``."""
    root = tmp_path_factory.mktemp("s2w")
    rng = np.random.RandomState(1)
    for sub, n in (("trainA", 26), ("trainB", 14)):
        (root / sub).mkdir()
        for i in range(n):
            Image.fromarray((rng.rand(48, 48, 3) * 255).astype(np.uint8)).save(
                root / sub / f"{i}.jpg")
    return torch_loader_cases.Epochal(tdata.Summer2WinterDataset(
        str(root), "train",
        augment=tdata.AugmentConfig(out_size=32, hflip_p=0.5),
        color_jitter=tdata.ColorJitterConfig(0.2, 0.2, 0.2, 0.1),
        uint8_output=True))


#: the loaders of one epoch, each over the dataset (a remainder loader over
#: its first len % 6 samples, as the benchmark warms that batch)
POOL_CASES = {
    "whole": dict(batch_size=6, shuffle=True, seed=3, num_workers=3),
    "shard1of2": dict(batch_size=6, shuffle=True, seed=3, num_workers=3,
                      shard_index=1, shard_count=2),
    "remainder": dict(batch_size=2, num_workers=3),
}


def _pool_loader(ds, case, processes):
    kw = POOL_CASES[case]
    if case == "remainder":
        ds = tdata.Subset(ds, range(len(ds) % 6))
    return tdata.DataLoader(ds, use_processes=processes, **kw)


def _epochs(ds, loaders, epochs=2):
    """Per epoch (``ds.epoch`` set first), each loader's batches, the
    loaders read in turns, a batch each, so their epochs interleave."""
    out = []
    for epoch in range(epochs):
        ds.epoch = epoch
        its = [iter(ld) for ld in loaders]
        got = [[] for _ in loaders]
        while its:
            for i, it in list(enumerate(its)):
                batch = next(it, None)
                if batch is None:
                    its[i] = None
                else:
                    got[i].append(batch)
            its = [it for it in its if it is not None]
        out.append(got)
    return out


def _same_batches(got, want):
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert_items_equal(a, b)


@pytest.mark.parametrize("case", sorted(POOL_CASES))
def test_loader_processes_match_threads(s2w_epochal, case):
    """Over two epochs with the dataset changed between them, the worker
    processes give the threads' batches byte for byte: each epoch sends
    the dataset as it stands (a pool holding the dataset of its spawn
    would give epoch 0's samples again)."""
    ds = s2w_epochal
    procs, threads = (_pool_loader(ds, case, p) for p in (True, False))
    assert procs.in_processes and not threads.in_processes
    (p0, t0), (p1, t1) = _epochs(ds, [procs, threads])
    _same_batches(p0, t0)
    _same_batches(p1, t1)
    assert p0[0]["x"].tobytes() != p1[0]["x"].tobytes()


def test_loaders_share_one_pool(s2w_epochal):
    """The three loaders of one process, read in turns, share one pool
    (each epoch its own generation of the dataset) and give the threads'
    batches."""
    ds = s2w_epochal
    procs = [_pool_loader(ds, c, True) for c in sorted(POOL_CASES)]
    threads = [_pool_loader(ds, c, False) for c in sorted(POOL_CASES)]
    pool = tdata.loader._POOL.executor(1)
    for got, want in zip(_epochs(ds, procs), _epochs(ds, threads)):
        for g, w in zip(got, want):
            _same_batches(g, w)
    assert tdata.loader._POOL.executor(3) is pool


@pytest.mark.parametrize("case,want", [
    ("host_augmented", True), ("raw_frames", False),
    ("host_augmented_forced_threads", False),
    ("raw_frames_forced_processes", True)])
def test_loader_chooses_processes_from_the_samples(dataset_root, s2w_epochal,
                                                   case, want):
    """Host-augmented samples are built in processes, raw frames for the
    card in threads; ``use_processes`` forces either."""
    if case.startswith("raw_frames"):
        ds = tdata.HypersimDataset(
            str(dataset_root / "hypersim"), ["depth", "normal"],
            augment=tdata.AugmentConfig(out_size=16, hflip_p=0.5),
            paired_mode=False, raw_mode=True)
    else:
        ds = s2w_epochal
    forced = {"forced_threads": False, "forced_processes": True}
    use = next((v for k, v in forced.items() if case.endswith(k)), None)
    loader = tdata.DataLoader(ds, 4, shuffle=True, use_processes=use)
    assert loader.in_processes is want
    if case == "raw_frames_forced_processes":
        threads = tdata.DataLoader(ds, 4, shuffle=True, use_processes=False)
        _same_batches(list(loader), list(threads))


def test_processes_decode_where_the_cache_files_are_gone(dataset_root,
                                                        tmp_path):
    """A decode cache attached in this process whose files were removed
    since (still open here) cannot be attached in a worker: the workers
    decode from the image files and give the threads' bytes."""
    cache = tdata.DecodedImageCache(tdata.DecodedImageCache.build(
        dataset_root / "hypersim", tmp_path / "gone.cache")).attach()
    try:
        for path in (cache.cache_path, cache.cache_path.with_suffix(".json")):
            path.unlink()
        ds = tdata.HypersimDataset(
            str(dataset_root / "hypersim"), ["depth", "normal"],
            augment=tdata.AugmentConfig(out_size=16, hflip_p=0.5),
            paired_mode=False, uint8_output=True)
        got, want = (list(tdata.DataLoader(ds, 4, shuffle=True, seed=4,
                                           use_processes=p))
                     for p in (True, False))
        _same_batches(got, want)
    finally:
        tdatasets.set_decode_cache(None)


def test_cache_matches_jax(dataset_root, tmp_path):
    """The port's DecodedImageCache writes the JAX package's .bin/.json
    bytes, reads the JAX package's cache, and a cache-attached dataset
    yields the same samples on both sides."""
    root = dataset_root / "hypersim"
    pblob = tdata.DecodedImageCache.build(root, tmp_path / "port.cache")
    jblob = jdata.DecodedImageCache.build(root, tmp_path / "jax.cache")
    assert pblob.read_bytes() == jblob.read_bytes()
    assert (pblob.with_suffix(".json").read_bytes()
            == jblob.with_suffix(".json").read_bytes())
    port_cache = tdata.DecodedImageCache(jblob)
    jax_cache = jdata.DecodedImageCache(jblob)
    assert len(port_cache) == len(jax_cache) == 36
    path = sorted(root.rglob("*.png"))[5]
    assert port_cache.get(path).tobytes() == jax_cache.get(path).tobytes()
    port_cache.attach()
    jax_cache.attach()
    try:
        for raw in (False, True):
            port, ref = (m.HypersimDataset(
                str(root), ["depth", "normal"],
                augment=m.AugmentConfig(out_size=16, hflip_p=0.5),
                paired_mode=False, raw_mode=raw) for m in (tdata, jdata))
            for i in range(4):
                assert_items_equal(port.get(i, random.Random(i)),
                                   ref.get(i, random.Random(i)))
    finally:
        tdatasets.set_decode_cache(None)
        jdatasets.set_decode_cache(None)


def test_native_builds_under_build_and_decodes_as_jax(dataset_root, tmp_path):
    """The port's C++ data plane builds into build/data/ at the repository
    root (not into the package) and decodes, resizes and gathers as the
    JAX package's does, byte for byte."""
    assert tnative.available(), tnative.status()
    assert tnative.status().startswith("built: ")
    assert tnative._SO.parent == tnative.BUILD_DIR == Path(ROOT, "build",
                                                           "data")
    assert tnative._SO.exists()
    assert not list(tnative._SRC.parent.glob("*.so"))
    pngs = sorted((dataset_root / "hypersim").rglob("*.png"))[:4]
    jpgs = sorted((dataset_root / "summer2winter").rglob("*.jpg"))[:2]
    for p in pngs + jpgs:
        assert tnative.probe_rgb(p) == jnative.probe_rgb(p)
        assert tnative.decode_rgb(p).tobytes() == jnative.decode_rgb(p).tobytes()
    for a, b in zip(tnative.decode_many(pngs + jpgs + [tmp_path / "no.png"]),
                    jnative.decode_many(pngs + jpgs + [tmp_path / "no.png"])):
        assert (a is None and b is None) or a.tobytes() == b.tobytes()
    arr = tnative.decode_rgb(pngs[0])
    for crop in (None, (3, 5, 30)):
        assert (tnative.resize_rgb8(arr, 24, 24, crop=crop).tobytes()
                == jnative.resize_rgb8(arr, 24, 24, crop=crop).tobytes())
    blob = np.arange(4096, dtype=np.uint8)
    outs = [np.zeros(246, np.uint8) for _ in range(2)]
    for mod, out in zip((tnative, jnative), outs):
        assert mod.gather(blob, [0, 1000, 2000, 4000], [100, 50, 48, 48], out)
    assert outs[0].tobytes() == outs[1].tobytes()


def test_native_switch_off(monkeypatch, dataset_root):
    """VCT_NATIVE=0 turns the native path off, says so, and the dataset
    then takes the PIL path."""
    monkeypatch.setenv("VCT_NATIVE", "0")
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_lib_tried", False)
    assert not tnative.available()
    assert "VCT_NATIVE=0" in tnative.status()
    png = sorted((dataset_root / "hypersim").rglob("*.png"))[0]
    assert tnative.decode_rgb(png) is None
    ds = tdata.HypersimDataset(str(dataset_root / "hypersim"), ["depth"])
    want = np.asarray(Image.open(ds.samples[0]["modality_paths"]["depth"])
                      .convert("RGB"), np.float32) / 255.0
    np.testing.assert_array_equal(ds.get(0, random.Random(0))["x"], want)


# ---------------------------------------------------------------------------
# on-device augmentation
# ---------------------------------------------------------------------------


def test_aug_vectors_match_jax():
    """crop_box and sample_aug_vector are JAX's, value for value, on the
    random-crop and the eval configurations and odd frame sizes."""
    for cfg_kw in (dict(out_size=16, hflip_p=0.5, vflip_p=0.3),
                   dict(out_size=64, crop_scale=(0.05, 0.2)),
                   dict(out_size=16, random_crop=False, hflip_p=0.5)):
        tcfg, jcfg = tdata.AugmentConfig(**cfg_kw), jdata.AugmentConfig(**cfg_kw)
        for seed in range(50):
            for w, h in ((56, 40), (1024, 768), (33, 97)):
                a = taug.sample_aug_vector(random.Random(seed), tcfg, w, h)
                b = jaug.sample_aug_vector(random.Random(seed), jcfg, w, h)
                assert a.dtype == b.dtype == np.float32
                assert a.tobytes() == b.tobytes()
                p = tdata.transforms.sample_spatial_params(
                    random.Random(seed), tcfg)
                jp = jdata.transforms.sample_spatial_params(
                    random.Random(seed), jcfg)
                assert (taug.crop_box(p, w, h, tcfg)
                        == jaug.crop_box(jp, w, h, jcfg))


AUG_CASES = {
    # random crops (downsampling: the kernel widened by 1/scale) with flips
    "crops_with_flips": (48, 64, dict(out_size=16, hflip_p=0.5, vflip_p=0.5)),
    # crops smaller than the output: upsampling, the kernel not widened
    "upsampling_crop": (40, 56, dict(out_size=64, hflip_p=0.5, vflip_p=0.5,
                                     crop_scale=(0.1, 0.3))),
    # the eval vector: the whole non-square frame, side_h != side_w
    "non_square_eval": (40, 56, dict(out_size=32, random_crop=False,
                                     hflip_p=0.5, vflip_p=0.5)),
}


@pytest.mark.parametrize("case", sorted(AUG_CASES))
def test_device_augment_matches_jax(case):
    """The port's device_augment on the same uint8 frames and aug vectors
    within atol 1e-5 of JAX's (jax.image.scale_and_translate, cubic,
    antialias): measured at most 3.0e-7 in each case."""
    h, w, cfg_kw = AUG_CASES[case]
    cfg = tdata.AugmentConfig(**cfg_kw)
    rng = np.random.RandomState(1)
    raw = (rng.rand(8, h, w, 3) * 255).astype(np.uint8)
    aug = np.stack([taug.sample_aug_vector(random.Random(s), cfg, w, h)
                    for s in range(8)])
    if case == "upsampling_crop":
        assert (aug[:, 4] < cfg.out_size).all()
    if case == "non_square_eval":
        assert (aug[:, 4] != aug[:, 5]).all()
    assert aug[:, 0].any() and aug[:, 1].any() and not aug[:, :2].all()
    want = np.asarray(jaug.device_augment(jnp.asarray(raw), jnp.asarray(aug),
                                          cfg.out_size))
    got = taug.device_augment(torch.from_numpy(raw), torch.from_numpy(aug),
                              cfg.out_size)
    assert got.dtype == torch.float32
    assert tuple(got.shape) == want.shape == (8, cfg.out_size,
                                              cfg.out_size, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=AUG_ATOL)


def test_augment_batch_maps_raw_keys_as_jax(dataset_root):
    """augment_batch turns a raw loader batch into {'x', 'y'} as JAX's does
    (other keys kept, non-raw batches passed through)."""
    ds = tdata.HypersimDataset(
        str(dataset_root / "hypersim"), ["depth", "normal"],
        augment=tdata.AugmentConfig(out_size=16, hflip_p=0.5),
        paired_mode=False, raw_mode=True)
    loader = tdata.DataLoader(ds, 4, shuffle=True, seed=2)
    batch = next(iter(loader))
    loader.close()
    batch["tag"] = np.arange(4)
    got = taug.augment_batch({k: torch.from_numpy(v)
                              for k, v in batch.items()}, 16)
    want = jaug.augment_batch({k: jnp.asarray(v) for k, v in batch.items()},
                              16)
    assert set(got) == set(want) == {"x", "y", "tag"}
    for k in ("x", "y"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=AUG_ATOL)
    plain = {"x": torch.zeros(1, 16, 16, 3)}
    assert taug.augment_batch(plain, 16) is plain


def test_port_imports_without_pillow():
    """Every module of the port, data included, imports with Pillow
    blocked, and a path that needs Pillow then raises ImportError."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['PIL'] = None\n"
        "import vae_cyclegan_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "p.__name__ + '.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "assert 'vae_cyclegan_tpu_torch.data.datasets' in names\n"
        "from vae_cyclegan_tpu_torch.data import transforms as t\n"
        "try:\n"
        "    t.apply_spatial_pil(None, t.AugmentConfig(), None)\n"
        "except ImportError:\n"
        "    print('ok', len(names))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")
