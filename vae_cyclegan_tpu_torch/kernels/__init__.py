"""Build and bind the hand-written Hopper kernels, and record where the
dispatch rules pick them.

The CUDA C++ sources live in ``vae_cyclegan_tpu_torch/csrc/``. At first use
:func:`load` compiles them for ``sm_90a``, one ``nvcc`` process per source,
all started together, and links them into one shared library with a plain C
interface, ``build/kernels/vct_kernels_<hash>.so`` at
the repository root (keyed by a hash of the sources and flags, so an edited
source rebuilds), and opens it with ``ctypes``. Nothing is built or imported
when this module is imported: the CPU tests import every module, and the CPU
has no ``nvcc``.

The wrappers that launch the kernels live next to their plain PyTorch
versions: ``ops.instance_norm.in_act_cuda`` and ``in_act_tiled_cuda``, K1's
backward ``in_act_bwd_cuda``, K2's split
for spatial parallelism ``in_stats_cuda`` and ``in_apply_cuda``, and
``ops.starved_conv.reflect_conv_cuda``, ``zero_conv_cuda`` and ``dw_cuda``,
and for the conv prototypes of ``experiments/``
``experiments.conv_proto.conv_proto_cuda``,
``experiments.lowcin_conv2.lowcin_conv_cm_cuda``,
``experiments.lowcin_conv3.lowcin_conv_nhwc_cuda`` and
``experiments.dw_dot_probe.dot_probe_cuda``.

The model path reaches K1-K4 through custom operators, ``vct::in_act``
(and its backward, ``vct::in_act_bwd``), ``vct::in_act_tiled`` (and its
split, ``vct::in_stats`` and
``vct::in_apply``), ``vct::starved_conv`` and ``vct::starved_dw``
(``kernels.ops``): their dispatch sends a CUDA tensor to the wrapper and a
CPU tensor to the plain version, and ``torch.export`` records each call as
one node, so an exported generator launches the hand kernels on the card.
K5-K8 run on no model path and are called through their wrappers.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Iterator, List, Optional, Tuple

SRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry point -> (return type, argument types)
_SIGNATURES = {
    # (x, y, planes, hw, dtype, act, act_norm, eps, stream), K1 and K2
    "vct_in_act": (_I, [_P, _P, ctypes.c_longlong, ctypes.c_longlong, _I, _I,
                        _I, ctypes.c_float, _P]),
    "vct_in_act_tiled": (_I, [_P, _P, ctypes.c_longlong, ctypes.c_longlong,
                              _I, _I, _I, ctypes.c_float, _P]),
    # (x, stats, planes, hw, dtype, act, act_norm, stream), K2's stats pass
    "vct_in_stats": (_I, [_P, _P, ctypes.c_longlong, ctypes.c_longlong, _I,
                          _I, _I, _P]),
    # (x, stats, y, moments, planes, hw, 1 / count, dtype, act, act_norm,
    # eps, stream), K2's apply pass
    "vct_in_apply": (_I, [_P, _P, _P, _P, ctypes.c_longlong,
                          ctypes.c_longlong, ctypes.c_float, _I, _I, _I,
                          ctypes.c_float, _P]),
    # (hw, dtype, vector_ok, int[4] out) -> 0: the IN kernels' plane plan
    "vct_in_plane_plan": (_I, [ctypes.c_longlong, _I, _I, _P]),
    # (x, g, dx, planes, hw, dtype, act, act_norm, eps, stream), K1's
    # backward
    "vct_in_act_bwd": (_I, [_P, _P, _P, ctypes.c_longlong, ctypes.c_longlong,
                            _I, _I, _I, ctypes.c_float, _P]),
    # (hw, dtype, vector_ok, int[4] out) -> 0: the backward's plane plan
    "vct_in_act_bwd_plan": (_I, [ctypes.c_longlong, _I, _I, _P]),
    # (x, w, y, n, cin, cout, h, w, k, mode, dtype, stream)
    "vct_starved_conv": (_I, [_P, _P, _P] + [_I] * 8 + [_P]),
    # (n, cin, cout, h, w, k) -> floats of scratch, or -1
    "vct_dw_scratch_floats": (ctypes.c_longlong, [_I] * 6),
    # (x, g, dw, scratch, n, cin, cout, h, w, k, dtype, stream)
    "vct_starved_dw": (_I, [_P] * 4 + [_I] * 7 + [_P]),
    # (xp, wk, y, n, h, w, cin, cout, k, fold, dtype, stream), K5
    "vct_conv_proto": (_I, [_P] * 3 + [_I] * 8 + [_P]),
    # (x, wk, y, n, h, w, cin, cout, k, fold, dtype, stream), K7
    "vct_lowcin_nhwc": (_I, [_P] * 3 + [_I] * 8 + [_P]),
    # (xp, wk, y, n, h, w, cin, cout, k, wp, fold, dtype, stream), K6
    "vct_lowcin_conv": (_I, [_P] * 3 + [_I] * 9 + [_P]),
    # (p, g, out, mk, nk, kk, steps, dtype, tn, cluster, kslice, stream), K8
    "vct_dot_probe": (_I, [_P] * 3 + [_I] * 8 + [_P]),
    # (kk, dtype, tn, cluster, kslice, long long[2] out) -> 0: K8's shared
    # bytes a CTA and the clusters the card places at once
    "vct_dot_probe_query": (_I, [_I] * 5 + [_P]),
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
#: compiler output (ptxas register / shared-memory report) and seconds of
#: the build this process ran, or None when the library was already built
build_log: Optional[str] = None
build_seconds: Optional[float] = None


def _sources() -> List[Path]:
    return sorted(SRC_DIR.glob("*.cu")) + sorted(SRC_DIR.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    candidate = home / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found on PATH or under CUDA_HOME "
        f"({home}); the CUDA kernels cannot be built")


def library_path(build_dir: Path = BUILD_DIR) -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return build_dir / f"vct_kernels_{digest.hexdigest()[:16]}.so"


def build(build_dir: Path = BUILD_DIR) -> Path:
    """Compile the sources into the shared library unless it exists.
    Raises RuntimeError (with the compiler's output) when nvcc is missing
    or the build fails."""
    global build_log, build_seconds
    so = library_path(build_dir)
    if so.exists():
        return so
    nvcc = _nvcc()
    build_dir.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    try:
        # one nvcc per source, all started together, then one link
        objs, procs = [], []
        for src in (s for s in _sources() if s.suffix == ".cu"):
            objs.append(f"{tmp}.{src.stem}.o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", objs[-1], str(src)]
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        runs = [(cmd, proc.communicate()[0], proc.returncode)
                for cmd, proc in procs]
        link = [nvcc, "-shared", "-o", str(tmp), *objs]
        proc = subprocess.run(link, capture_output=True, text=True)
        runs.append((link, proc.stdout + proc.stderr, proc.returncode))
        for cmd, out, rc in runs:
            if rc != 0:
                raise RuntimeError(
                    f"nvcc failed ({rc}): {' '.join(cmd)}\n{out}")
        os.replace(tmp, so)
    finally:
        for obj in objs:
            Path(obj).unlink(missing_ok=True)
    build_seconds = time.perf_counter() - t0
    build_log = "".join(out for _, out, _ in runs)
    return so


def load(build_dir: Path = BUILD_DIR) -> ctypes.CDLL:
    """The kernels' shared library, built at first use."""
    global _lib
    if _lib is not None:  # bound once; the lock guards the first build
        return _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build(build_dir)))
            for name, (restype, argtypes) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _lib = lib
        return _lib


def check(rc: int, name: str) -> None:
    """Raise when a C entry point reports a CUDA error for its launch."""
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {rc}")


# ---------------------------------------------------------------------------
# site recording: where the dispatch rules pick a kernel, on any device
# ---------------------------------------------------------------------------

Site = Tuple[str, tuple, str, Optional[int], Optional[int], Optional[int],
             Optional[str], Optional[str]]
_recorders: List[List[Site]] = []


@contextlib.contextmanager
def record_sites() -> Iterator[List[Site]]:
    """Collect ``(kind, shape, dtype, k, cin, cout, act, order)`` for every
    call whose dispatch rule picks a kernel while the block is active,
    whatever the tensor's device (``meta`` included, where the plain
    version then runs). ``kind`` is ``"in_act"``, ``"in_act_tiled"``,
    ``"starved_conv"`` (the
    reflect forward), ``"starved_conv_dx"`` (the zero_same core of the
    input gradient) or ``"starved_conv_dw"`` (the weight gradient).
    ``shape`` is the NCHW shape of the kernel's first input (x, or for dx
    the incoming gradient); k, cin and cout are those of the conv the
    kernel computes (for dx, the rotated one: cin and cout swap; for dw,
    the forward's)."""
    sites: List[Site] = []
    _recorders.append(sites)
    try:
        yield sites
    finally:
        _recorders.remove(sites)


def note_site(kind: str, shape, dtype, k=None, cin=None, cout=None,
              act=None, order=None) -> None:
    if _recorders:
        site = (kind, tuple(shape), str(dtype).replace("torch.", ""), k, cin,
                cout, act, order)
        for sites in _recorders:
            sites.append(site)
