"""Hypersim dataset tooling.

Two subcommands, replacing the reference's standalone scripts
(`download_dataset_sample.py`, `show_modalities.py`) with one module:

    python -m vae_cyclegan_tpu_torch.data.tools sample \
        --num_images 40 --modalities depth normal --output_dir dataset/hypersim
    python -m vae_cyclegan_tpu_torch.data.tools show --dataset dataset/hypersim

`sample` pulls individual frames out of the per-scene ZIPs on Apple's CDN
with HTTP Range requests (a scene ZIP is tens of GB; a frame is a few MB)
and writes the training layout `{scene}_{type}/cam_XX/frame_NNNN_{mod}.png`
that `HypersimDataset` consumes.  `show` renders one downloaded frame's
modalities as a captioned contact sheet plus individual PNGs.

Dataset facts (CDN URL, ZIP-internal paths, modality names, metadata CSV
locations in the apple/ml-hypersim repo) follow the published dataset; the
colormap conventions (plasma for scalar fields, tab20 for id maps,
[-1,1]->[0,1] for normals) match the reference tool's output format.

Counterpart of ``vae_cyclegan_tpu/data/tools.py``, copied: the same
subcommands, outputs and cache format. `cache` builds what the port's
``python -m vae_cyclegan_tpu_torch.train --decode_cache`` reads.
"""

from __future__ import annotations

import argparse
import io
import re
import zipfile
from collections import defaultdict
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterable, List, NamedTuple, Optional

import numpy as np

CDN = (
    "https://docs-assets.developer.apple.com/ml-research/datasets/hypersim/"
    "v1/scenes/"
)

# Where each modality lives inside a scene ZIP and how to draw it.
#   subdir: scene_cam_XX_{subdir} under {scene}/images/
#   suffix: file name after "frame.NNNN."
#   style:  renderer key (see _RENDER below)
@dataclass(frozen=True)
class Source:
    subdir: str
    suffix: str
    style: str


SOURCES: Dict[str, Source] = {
    "color": Source("final_preview", "tonemap.jpg", "photo"),
    "depth": Source("geometry_hdf5", "depth_meters.hdf5", "scalar"),
    "position": Source("geometry_hdf5", "position.hdf5", "scalar"),
    "normal": Source("geometry_hdf5", "normal_cam.hdf5", "vectors"),
    "normal_world": Source("geometry_hdf5", "normal_world.hdf5", "vectors"),
    "normal_bump": Source("geometry_hdf5", "normal_bump_cam.hdf5", "vectors"),
    "semantic": Source("geometry_hdf5", "semantic.hdf5", "ids"),
    "semantic_instance": Source(
        "geometry_hdf5", "semantic_instance.hdf5", "ids"
    ),
    "render_entity_id": Source(
        "geometry_hdf5", "render_entity_id.hdf5", "ids"
    ),
}

CAPTIONS = {
    "color": "tonemapped RGB render",
    "depth": "distance from camera, plasma-mapped",
    "position": "world-space XYZ position",
    "normal": "camera-space unit normals",
    "normal_world": "world-space unit normals",
    "normal_bump": "normals incl. bump mapping",
    "semantic": "semantic class ids",
    "semantic_instance": "per-instance ids",
    "render_entity_id": "per-entity render ids",
}


class FrameRef(NamedTuple):
    scene: str
    cam: str  # "cam_00"
    frame: int


# ---------------------------------------------------------------------------
# rendering: decoded arrays -> uint8 RGB


def _unit(a: np.ndarray) -> np.ndarray:
    """Min-max scale the finite values to [0,1]; non-finite pixels -> 0
    (sky pixels in depth maps are inf)."""
    a = np.asarray(a, np.float32)
    ok = np.isfinite(a)
    if not ok.any():
        return np.zeros_like(a)
    lo, hi = a[ok].min(), a[ok].max()
    u = np.zeros_like(a) if hi <= lo else (a - lo) / (hi - lo)
    u[~ok] = 0.0
    return u


def _cmap(name: str, a: np.ndarray) -> np.ndarray:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if a.ndim != 2:  # multi-channel scalar fields (e.g. position): no cmap
        return _unit(a)
    return plt.get_cmap(name)(_unit(a))[..., :3]


_RENDER = {
    "photo": lambda a: np.asarray(a, np.float32) / 255.0,
    "scalar": lambda a: _cmap("plasma", a),
    "ids": lambda a: _cmap("tab20", a),
    "vectors": lambda a: np.clip((np.asarray(a, np.float32) + 1.0) / 2.0, 0, 1),
}


def render(modality: str, data: np.ndarray) -> np.ndarray:
    """Decoded payload -> uint8 RGB image."""
    img = _RENDER[SOURCES[modality].style](data)
    return (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


# ---------------------------------------------------------------------------
# remote access: a real io.RawIOBase over HTTP Range requests, so zipfile
# sees a buffered, seekable stream (central-directory reads are chunked by
# io.BufferedReader instead of one GET per tiny read)


class HttpRangeReader(io.RawIOBase):
    def __init__(self, url: str, session):
        head = session.head(url)
        head.raise_for_status()
        self._url = url
        self._http = session
        self._size = int(head.headers["content-length"])
        self._pos = 0

    def seekable(self) -> bool:
        return True

    def readable(self) -> bool:
        return True

    def tell(self) -> int:
        return self._pos

    def seek(self, offset: int, whence: int = io.SEEK_SET) -> int:
        origin = {
            io.SEEK_SET: 0,
            io.SEEK_CUR: self._pos,
            io.SEEK_END: self._size,
        }[whence]
        self._pos = max(0, min(self._size, origin + offset))
        return self._pos

    def readinto(self, buf) -> int:
        n = min(len(buf), self._size - self._pos)
        if n <= 0:
            return 0
        rng = {"Range": f"bytes={self._pos}-{self._pos + n - 1}"}
        resp = self._http.get(self._url, headers=rng)
        resp.raise_for_status()
        data = resp.content[:n]
        buf[: len(data)] = data
        self._pos += len(data)
        return len(data)


# ---------------------------------------------------------------------------
# scene archives


class SceneArchive:
    """One scene's ZIP (remote over HTTP-Range, or a local file)."""

    def __init__(self, zf: zipfile.ZipFile, scene: str):
        self._zf = zf
        self.scene = scene
        self._members = set(zf.namelist())

    @classmethod
    def open(cls, scene: str, base: str = CDN) -> "SceneArchive":
        if str(base).startswith("http"):
            import requests

            raw = HttpRangeReader(f"{base}{scene}.zip", requests.Session())
            return cls(zipfile.ZipFile(io.BufferedReader(raw, 1 << 18)), scene)
        return cls(zipfile.ZipFile(Path(base) / f"{scene}.zip"), scene)

    def __enter__(self) -> "SceneArchive":
        return self

    def __exit__(self, *exc) -> None:
        self._zf.close()

    def member(self, ref: FrameRef, modality: str) -> str:
        src = SOURCES[modality]
        cam_id = ref.cam.removeprefix("cam_")
        return (
            f"{ref.scene}/images/scene_cam_{cam_id}_{src.subdir}/"
            f"frame.{ref.frame:04d}.{src.suffix}"
        )

    def has(self, ref: FrameRef, modality: str) -> bool:
        return self.member(ref, modality) in self._members

    def load(self, ref: FrameRef, modality: str) -> np.ndarray:
        """Fetch + decode one modality payload (pre-render)."""
        raw = self._zf.read(self.member(ref, modality))
        if SOURCES[modality].suffix.endswith(".hdf5"):
            import h5py

            with h5py.File(io.BytesIO(raw), "r") as f:
                return np.asarray(f["dataset"])
        from PIL import Image

        return np.asarray(Image.open(io.BytesIO(raw)).convert("RGB"))


def export_frame(
    archive: SceneArchive,
    ref: FrameRef,
    modalities: Iterable[str],
    out_root,
    scene_label: str,
) -> int:
    """Write one frame's modalities as training-layout PNGs; returns the
    number of modalities present (existing files are kept, not refetched)."""
    from PIL import Image

    cam_dir = Path(out_root) / scene_label / ref.cam
    cam_dir.mkdir(parents=True, exist_ok=True)
    written = 0
    for mod in modalities:
        if not archive.has(ref, mod):
            continue
        dest = cam_dir / f"frame_{ref.frame:04d}_{mod}.png"
        if not dest.exists():
            Image.fromarray(render(mod, archive.load(ref, mod))).save(dest)
        written += 1
    return written


# ---------------------------------------------------------------------------
# planning over the ml-hypersim metadata


class HypersimCatalog:
    """Frame inventory from the apple/ml-hypersim metadata CSVs."""

    def __init__(self, frames, scene_types: Optional[Dict[str, str]] = None):
        self.frames = frames[frames["included_in_public_release"]]
        self.scene_types = scene_types or {}

    @classmethod
    def from_repo(cls, repo_path=None) -> "HypersimCatalog":
        import pandas as pd

        analysis = (
            Path(repo_path or "../../") / "evermotion_dataset" / "analysis"
        )
        frames = pd.read_csv(analysis / "metadata_images.csv")
        types: Dict[str, str] = {}
        traj = analysis / "metadata_camera_trajectories.csv"
        if traj.exists():
            tdf = pd.read_csv(traj)
            for anim, stype in zip(tdf["Animation"], tdf["Scene type"]):
                scene = "_".join(str(anim).split("_")[:3])
                types.setdefault(scene, str(stype))
        return cls(frames, types)

    def scene_label(self, scene: str) -> str:
        kind = str(self.scene_types.get(scene, "unknown")).lower()
        slug = re.sub(r"[()]", "", kind).strip().replace(" ", "_")
        return f"{scene}_{slug}"

    def spread(self, n: int) -> List[FrameRef]:
        """Deterministic diversity-first selection: visit scenes round-robin
        (each scene's first camera, frames in order), dropping a scene once
        its frames are exhausted — never selects duplicates."""
        menu: Dict[str, tuple] = {}
        for scene, grp in self.frames.groupby("scene_name"):
            cam = sorted(grp["camera_name"].unique())[0]
            frs = sorted(grp.loc[grp["camera_name"] == cam, "frame_id"].unique())
            if frs:
                menu[scene] = (cam, frs)
        picks: List[FrameRef] = []
        lap, live = 0, sorted(menu)
        while live and len(picks) < n:
            remaining = []
            for scene in live:
                cam, frs = menu[scene]
                if lap < len(frs):
                    picks.append(FrameRef(scene, cam, int(frs[lap])))
                    remaining.append(scene)
                    if len(picks) >= n:
                        break
            live, lap = remaining, lap + 1
        return picks


# ---------------------------------------------------------------------------
# local-tree inspection (the `show` half)

_FRAME_PNG = re.compile(r"frame_(\d+)_(\w+)\.png$")


def scan_tree(root) -> Dict[FrameRef, Dict[str, Path]]:
    """Index a downloaded tree: FrameRef -> {modality: png path}. Only
    frames that actually exist on disk are returned, so selection can never
    point at a missing frame."""
    frames: Dict[FrameRef, Dict[str, Path]] = defaultdict(dict)
    for png in sorted(Path(root).glob("*/cam_*/frame_*.png")):
        m = _FRAME_PNG.match(png.name)
        if m:
            ref = FrameRef(
                png.parent.parent.name, png.parent.name, int(m.group(1))
            )
            frames[ref][m.group(2)] = png
    if not frames:
        raise FileNotFoundError(f"no hypersim frames under {root}")
    return dict(frames)


def pick_frame(
    frames: Dict[FrameRef, Dict[str, Path]],
    scene: Optional[str] = None,
    frame: Optional[int] = None,
) -> FrameRef:
    refs = sorted(
        r
        for r in frames
        if (scene is None or r.scene == scene)
        and (frame is None or r.frame == frame)
    )
    if not refs:
        raise FileNotFoundError(
            f"no frame matches scene={scene!r} frame={frame!r}"
        )
    return refs[0]


def contact_sheet(
    images: Dict[str, np.ndarray], title: str, dest, columns: int = 3
):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    names = sorted(images)
    rows = -(-len(names) // columns)
    fig, axes = plt.subplots(
        rows, columns, figsize=(5 * columns, 4 * rows), squeeze=False
    )
    for ax, name in zip(axes.ravel(), names):
        ax.imshow(images[name])
        ax.set_title(f"{name}\n{CAPTIONS.get(name, '')}", fontsize=10)
    for ax in axes.ravel():
        ax.axis("off")
    fig.suptitle(title, fontsize=14)
    fig.tight_layout()
    dest = Path(dest)
    dest.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(dest, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return dest


def export_pngs(images: Dict[str, np.ndarray], out_dir) -> List[Path]:
    from PIL import Image

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = []
    for name, arr in images.items():
        p = out_dir / f"{name}.png"
        Image.fromarray(np.asarray(arr)).save(p)
        paths.append(p)
    return paths


# ---------------------------------------------------------------------------
# CLI


def cmd_sample(args) -> int:
    wanted = (
        list(SOURCES)
        if "all_modalities" in args.modalities
        else args.modalities
    )
    unknown = sorted(set(wanted) - set(SOURCES))
    if unknown:
        print(f"unknown modalities {unknown}; available: {sorted(SOURCES)}")
        return 1

    catalog = HypersimCatalog.from_repo(args.repo_path)
    plan = catalog.spread(args.num_images)
    by_scene: Dict[str, List[FrameRef]] = defaultdict(list)
    for ref in plan:
        by_scene[ref.scene].append(ref)
    print(f"plan: {len(plan)} frames over {len(by_scene)} scenes")

    done = missed = 0
    for scene, refs in by_scene.items():
        try:
            archive = SceneArchive.open(scene, args.base_url)
        except Exception as e:  # noqa: BLE001 — skip unreachable scenes
            print(f"  {scene}: cannot open archive ({e})")
            missed += len(refs)
            continue
        with archive:
            label = catalog.scene_label(scene)
            for ref in refs:
                n = export_frame(archive, ref, wanted, args.output_dir, label)
                done += bool(n)
                missed += not n
    print(f"wrote {done}/{len(plan)} frames ({missed} missing/failed) "
          f"to {Path(args.output_dir).absolute()}")
    return 0


def cmd_cache(args) -> int:
    from vae_cyclegan_tpu_torch.data.cache import DecodedImageCache

    blob = DecodedImageCache.build(args.root, args.out)
    cache = DecodedImageCache(blob)
    size = blob.stat().st_size
    print(f"cached {len(cache)} decoded images "
          f"({size / 1e6:.1f} MB) -> {blob}")
    return 0


def cmd_show(args) -> int:
    frames = scan_tree(args.dataset)
    ref = pick_frame(
        frames,
        scene=args.scene,
        frame=None if args.frame is None else int(args.frame),
    )
    from PIL import Image

    images = {
        mod: np.asarray(Image.open(p)) for mod, p in frames[ref].items()
    }
    print(f"showing {ref.scene}/{ref.cam} frame {ref.frame:04d} "
          f"({len(images)} modalities)")
    out = Path(args.output)
    sheet = contact_sheet(
        images,
        f"Hypersim modalities — {ref.scene} frame {ref.frame:04d}",
        out / f"modalities_grid_{ref.scene}.png",
    )
    saved = export_pngs(images, out / f"individual_{ref.scene}")
    print(f"wrote {sheet} and {len(saved)} individual PNGs")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m vae_cyclegan_tpu_torch.data.tools", description=__doc__
    )
    sub = ap.add_subparsers(dest="command", required=True)

    sp = sub.add_parser("sample", help="download a diverse Hypersim sample")
    sp.add_argument("--num_images", type=int, required=True)
    sp.add_argument("--modalities", nargs="+", required=True,
                    help="modality names, or 'all_modalities'")
    sp.add_argument("--output_dir", default="hypersim_sample")
    sp.add_argument("--seed", type=int, default=42,
                    help="kept for CLI compatibility; the plan is "
                         "deterministic and seed-independent")
    sp.add_argument("--repo_path", default=None,
                    help="path to a clone of apple/ml-hypersim (metadata CSVs)")
    sp.add_argument("--base_url", default=CDN,
                    help="scene-zip base URL or a local directory of "
                         "{scene}.zip files")
    sp.set_defaults(fn=cmd_sample)

    sc = sub.add_parser(
        "cache",
        help="decode every image under --root into a memory-mapped cache "
             "(datasets then skip PNG/JPEG decode entirely)",
    )
    sc.add_argument("--root", required=True)
    sc.add_argument("--out", required=True,
                    help="cache blob path (a .json index is written beside)")
    sc.set_defaults(fn=cmd_cache)

    sh = sub.add_parser("show", help="render one downloaded frame's modalities")
    sh.add_argument("--dataset", default="dataset/hypersim")
    sh.add_argument("--scene", default=None)
    sh.add_argument("--frame", default=None)
    sh.add_argument("--output", default="modalities_examples")
    sh.set_defaults(fn=cmd_show)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
