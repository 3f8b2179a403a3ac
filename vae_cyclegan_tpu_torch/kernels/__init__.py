"""Build and bind the hand-written Hopper kernels, and record where the
dispatch rules pick them.

The CUDA C++ sources live in ``vae_cyclegan_tpu_torch/csrc/``. At first use
:func:`load` compiles them with one ``nvcc`` call for ``sm_90a`` into a shared
library with a plain C interface, ``build/kernels/vct_kernels_<hash>.so`` at
the repository root (keyed by a hash of the sources and flags, so an edited
source rebuilds), and opens it with ``ctypes``. Nothing is built or imported
when this module is imported: the CPU tests import every module, and the CPU
has no ``nvcc``.

The wrappers that launch the kernels live next to their plain PyTorch
versions: ``ops.instance_norm.in_act_cuda`` and
``ops.starved_conv.reflect_conv_cuda``.
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
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_SIGNATURES = {
    # (x, y, planes, hw, dtype, act, act_norm, eps, stream)
    "vct_in_act": [_P, _P, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_float, _P],
    # (x, w, y, n, cin, cout, h, w, k, dtype, stream)
    "vct_reflect_conv": [_P, _P, _P] + [ctypes.c_int] * 7 + [_P],
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
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp),
           *[str(s) for s in _sources() if s.suffix == ".cu"]]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, so)
    build_seconds = time.perf_counter() - t0
    build_log = proc.stdout + proc.stderr
    return so


def load(build_dir: Path = BUILD_DIR) -> ctypes.CDLL:
    """The kernels' shared library, built at first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build(build_dir)))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
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
    version then runs). ``kind`` is ``"in_act"`` or ``"starved_conv"``;
    ``shape`` is the NCHW input shape."""
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
