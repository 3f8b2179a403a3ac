"""ctypes bindings for the vctdata C++ data-plane (see vctdata.cpp).

The shared library is compiled on demand with the system toolchain (g++ +
libpng/libjpeg/zlib) into ``build/data/`` at the repository root; every
entry point degrades gracefully to the PIL path when the toolchain, the
libraries, or the build are unavailable, so the framework never *requires*
the native component. Disable explicitly with VCT_NATIVE=0. ``available()``
says whether it is in use, and ``status()`` why not.

Counterpart of ``vae_cyclegan_tpu/data/native/``: the same C++ source and
bindings, built outside the package directory. This is the host's data
plane (decode, resize, gather), not a device kernel.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

_SRC = Path(__file__).resolve().parent / "vctdata.cpp"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "data"
_SO = BUILD_DIR / "_vctdata.so"

_lock = threading.Lock()
_lib = None
_lib_tried = False
#: why the library is not in use (the compiler's last lines, the switch, a
#: load error), or None while it is
_error: Optional[str] = None


def _build() -> bool:
    # Compile to a private temp name and os.replace() into place: multiple
    # loader worker processes can race on first use, and dlopen of a
    # half-written .so would fail nondeterministically (silent PIL
    # fallback). rename(2) within a directory is atomic, so every process
    # either sees no .so (and builds its own) or a complete one.
    global _error
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"_vctdata.tmp.{os.getpid()}.so"
    cmd = [
        "g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
        str(_SRC), "-o", str(tmp), "-lpng", "-ljpeg", "-lz", "-lpthread",
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True,
                       timeout=120)
        os.replace(tmp, _SO)
        return True
    except subprocess.CalledProcessError as e:
        _error = "g++ failed: " + " | ".join(
            (e.stderr or "").strip().splitlines()[:2])
    except (OSError, subprocess.TimeoutExpired) as e:
        _error = f"g++ did not run: {type(e).__name__}: {e}"
    tmp.unlink(missing_ok=True)
    return False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _lib_tried, _error
    with _lock:
        if _lib is not None or _lib_tried:
            return _lib
        _lib_tried = True
        if os.environ.get("VCT_NATIVE", "1") == "0":
            _error = "turned off (VCT_NATIVE=0)"
            return None
        if not _SO.exists() or _SO.stat().st_mtime < _SRC.stat().st_mtime:
            if not _build():
                return None
        try:
            lib = ctypes.CDLL(str(_SO))
        except OSError as e:
            _error = f"dlopen failed: {e}"
            return None
        lib.vct_probe_rgb.restype = ctypes.c_int
        lib.vct_probe_rgb.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int)]
        lib.vct_decode_rgb.restype = ctypes.c_int
        lib.vct_decode_rgb.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_long,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
        lib.vct_decode_many.restype = None
        lib.vct_decode_many.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
            ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_long),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.c_int]
        lib.vct_gather.restype = None
        lib.vct_gather.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_long),
            ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_long),
            ctypes.c_int, ctypes.c_char_p, ctypes.c_int]
        lib.vct_resize_rgb8.restype = None
        lib.vct_resize_rgb8.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_long,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def status() -> str:
    """'built: <library>' when the native library is in use, else why
    not."""
    if _load() is not None:
        return f"built: {_SO}"
    return f"not in use: {_error}"


def probe_rgb(path) -> Optional[Tuple[int, int]]:
    """(w, h) of an image file, header-only; None if unavailable."""
    lib = _load()
    if lib is None:
        return None
    w = ctypes.c_int()
    h = ctypes.c_int()
    if lib.vct_probe_rgb(str(path).encode(), ctypes.byref(w),
                         ctypes.byref(h)) != 0:
        return None
    return w.value, h.value


def decode_rgb(path) -> Optional[np.ndarray]:
    """Decode PNG/JPEG to an (H, W, 3) uint8 array; None on failure so
    callers fall back to PIL."""
    lib = _load()
    if lib is None:
        return None
    dims = probe_rgb(path)
    if dims is None:
        return None
    w, h = dims
    out = np.empty((h, w, 3), np.uint8)
    w2 = ctypes.c_int()
    h2 = ctypes.c_int()
    rc = lib.vct_decode_rgb(
        str(path).encode(), out.ctypes.data_as(ctypes.c_char_p),
        ctypes.c_long(out.nbytes), ctypes.byref(w2), ctypes.byref(h2))
    if rc != 0:
        return None
    return out


def decode_many(paths: Sequence, nthreads: int = 0
                ) -> Optional[List[Optional[np.ndarray]]]:
    """Threaded batch decode (GIL released in C); None if the native
    library is unavailable; per-image None entries on decode errors."""
    lib = _load()
    if lib is None:
        return None
    n = len(paths)
    if n == 0:
        return []
    nthreads = nthreads or (os.cpu_count() or 1)
    dims = [probe_rgb(p) for p in paths]
    bufs: List[Optional[np.ndarray]] = [
        np.empty((h, w, 3), np.uint8) if d is not None else None
        for d, (w, h) in ((d, d or (0, 0)) for d in dims)
    ]
    idx = [i for i, b in enumerate(bufs) if b is not None]
    if not idx:
        return bufs
    c_paths = (ctypes.c_char_p * len(idx))(
        *[str(paths[i]).encode() for i in idx])
    c_outs = (ctypes.c_void_p * len(idx))(
        *[bufs[i].ctypes.data for i in idx])
    c_caps = (ctypes.c_long * len(idx))(*[bufs[i].nbytes for i in idx])
    c_whs = (ctypes.c_int * (2 * len(idx)))()
    c_rcs = (ctypes.c_int * len(idx))()
    lib.vct_decode_many(c_paths, len(idx), c_outs, c_caps, c_whs, c_rcs,
                        nthreads)
    for j, i in enumerate(idx):
        if c_rcs[j] != 0:
            bufs[i] = None
    return bufs


def resize_rgb8(arr: np.ndarray, oh: int, ow: int,
                crop: Optional[Tuple[int, int, int]] = None,
                filter: str = "bicubic") -> Optional[np.ndarray]:
    """Pillow-compatible separable resize of an (H, W, 3) uint8 array,
    optionally of just the square crop `(top, left, side)` — the crop is
    fused via the source stride, no intermediate copy. None when the
    native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    if arr.dtype != np.uint8 or arr.ndim != 3 or arr.shape[2] != 3:
        return None
    if not arr.flags.c_contiguous:
        arr = np.ascontiguousarray(arr)
    h, w = arr.shape[:2]
    if crop is None:
        top, left, sh, sw = 0, 0, h, w
    else:
        top, left, side = crop
        sh = sw = side
        if top < 0 or left < 0 or top + side > h or left + side > w:
            return None
    out = np.empty((oh, ow, 3), np.uint8)
    src_ptr = arr.ctypes.data + (top * w + left) * 3
    lib.vct_resize_rgb8(
        ctypes.c_void_p(src_ptr), sh, sw, ctypes.c_long(w * 3),
        ctypes.c_void_p(out.ctypes.data), oh, ow,
        1 if filter == "bicubic" else 0)
    return out


def gather(blob: np.ndarray, src_offsets: Sequence[int],
           sizes: Sequence[int], out: np.ndarray,
           dst_offsets: Optional[Sequence[int]] = None,
           nthreads: int = 0) -> bool:
    """Threaded gather of blob slices into `out`; False -> caller copies
    in Python."""
    lib = _load()
    if lib is None:
        return False
    n = len(src_offsets)
    if dst_offsets is None:
        dst_offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    c_src = (ctypes.c_long * n)(*[int(v) for v in src_offsets])
    c_sz = (ctypes.c_long * n)(*[int(v) for v in sizes])
    c_dst = (ctypes.c_long * n)(*[int(v) for v in dst_offsets])
    lib.vct_gather(
        blob.ctypes.data_as(ctypes.c_char_p), c_src, c_sz, c_dst, n,
        out.ctypes.data_as(ctypes.c_char_p),
        nthreads or (os.cpu_count() or 1))
    return True
