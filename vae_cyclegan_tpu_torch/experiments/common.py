"""What the prototypes' entry points and wrappers share: the command line, the
device rule, the tensor and shape checks, the launch of a C entry point, and
the plain reflect conv in the prototypes' NHWC / HWIO layouts."""

from __future__ import annotations

import argparse
from typing import List, Optional

import torch
import torch.nn.functional as F

from vae_cyclegan_tpu_torch import kernels
from vae_cyclegan_tpu_torch.ops.instance_norm import DTYPE_CODES


def rup(a: int, m: int) -> int:
    return -(-a // m) * m


def parse_args(argv: Optional[List[str]], description: str,
               batch: int = 24, flags=()) -> argparse.Namespace:
    """--batch, --device and the on/off `flags` of one entry point."""
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--batch", type=int, default=batch)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels; the default) or cpu (the plain "
                         "versions, for tests)")
    for flag in flags:
        ap.add_argument(flag, action="store_true")
    return ap.parse_args(argv)


def resolve_device(name: str) -> torch.device:
    """The entry points run on the card unless asked for the CPU, and raise
    without a CUDA device. On the card the f32 plain versions must be true
    f32, so TF32 is turned off (cuDNN's f32 convs default to it)."""
    device = torch.device(name)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device (torch.cuda.is_available() is "
                               "False); pass --device cpu for the plain "
                               "versions")
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    return device


def check_operands(name: str, a: torch.Tensor, b: torch.Tensor) -> None:
    """The kernels' tensor rules: both on one CUDA device, contiguous, both
    float32 or both bfloat16, and no autograd."""
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"{name} kernel needs both tensors on one CUDA "
                         f"device, got {a.device} and {b.device}")
    if a.dtype not in DTYPE_CODES or b.dtype != a.dtype:
        raise TypeError(f"{name} kernel takes float32/bfloat16 tensors of "
                        f"one dtype, got {a.dtype} and {b.dtype}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError(f"{name} kernel takes contiguous tensors")
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        raise RuntimeError(f"{name} kernel is not differentiable")


def check_conv(name: str, x: torch.Tensor, w: torch.Tensor, R: int) -> None:
    """The conv prototypes' shapes: NHWC x, HWIO w (k, k, cin, cout) with odd
    k, a reflect pad narrower than the image, and R dividing h. The TPU grid
    is h // R, so there R not dividing h leaves the last rows unwritten; here
    it raises."""
    if x.dim() != 4 or w.dim() != 4:
        raise ValueError(f"{name}: x must be NHWC and w HWIO, got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    n, h, wd, cin = x.shape
    k, k2, cin_w, cout = w.shape
    if k != k2 or k % 2 == 0 or cin_w != cin or n == 0 or cout == 0:
        raise ValueError(f"{name}: cannot take x {tuple(x.shape)} with w "
                         f"{tuple(w.shape)}")
    if k // 2 >= min(h, wd):
        raise ValueError(f"{name}: a reflect pad of {k // 2} needs h and w "
                         f"above it, got {h}x{wd}")
    if R <= 0 or h % R:
        raise ValueError(f"{name}: R={R} does not divide h={h}")


def launch(entry: str, device: torch.device, *args) -> None:
    """Call the C entry point `entry` with `args` and the current stream of
    `device`; raise on the launch's CUDA error."""
    lib = kernels.load()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, entry)(*args, stream)
    kernels.check(rc, entry)


# csrc/nhwc_conv.cuh's kFoldCols: K5 and K7 fold the dx taps into N where
# k * cout is at most this (the k7 tail's 3 output channels)
FOLD_COLS = 32


def nhwc_weight(w: torch.Tensor, dx_outer: bool):
    """The HWIO weight (k, k, cin, cout) as the NHWC conv core (K5, K7)
    reads it, and whether the launch folds the dx taps into N: cin
    zero-padded to whole 16-byte chunks (8 bf16, 4 f32), then the rows
    (cout, k * k * cin_s), K ordered (dy, dx, ci) or, with `dx_outer`,
    (dx, dy, ci); where k * cout <= FOLD_COLS the rows (cout * k, k *
    cin_s), row co * k + dx, K ordered (dy, ci)."""
    k, _, cin, cout = w.shape
    per_chunk = 16 // w.element_size()
    wp = F.pad(w, (0, 0, 0, rup(cin, per_chunk) - cin))
    fold = k * cout <= FOLD_COLS
    if fold or dx_outer:
        wk = wp.permute(3, 1, 0, 2)  # (cout, dx, dy, ci)
    else:
        wk = wp.permute(3, 0, 1, 2)  # (cout, dy, dx, ci)
    return wk.reshape(cout * k if fold else cout, -1).contiguous(), fold


def launch_nhwc(entry: str, src: torch.Tensor, x: torch.Tensor,
                w: torch.Tensor, dx_outer: bool) -> torch.Tensor:
    """Launch a kernel of the NHWC conv core (`entry`: vct_conv_proto, K5,
    or vct_lowcin_nhwc, K7) on `src` (what its loader reads: K5 the padded
    copy, K7 x itself) for the conv of NHWC x with HWIO w; NHWC y out in x's
    dtype. A block holds the weights of its channel tile (csrc/nhwc_conv.cuh's
    ``dispatch``: 64, 128 where cout > 64, 16 where cout <= 16, the folded
    32 rows; 32 or 16 in f32) and two slabs of R + k - 1 rows of BM + k - 1
    positions in shared memory, 227 KB at most (the prototypes' largest, the
    folded tail, take 224.5 KB in bf16); a shape past that fails to launch
    (RuntimeError)."""
    n, h, wd, cin = x.shape
    k, _, _, cout = w.shape
    wk, fold = nhwc_weight(w, dx_outer)
    y = torch.empty((n, h, wd, cout), dtype=x.dtype, device=x.device)
    launch(entry, x.device, src.data_ptr(), wk.data_ptr(), y.data_ptr(), n,
           h, wd, cin, cout, k, int(fold), DTYPE_CODES[x.dtype])
    return y


def reflect_pad_into(dst: torch.Tensor, src: torch.Tensor, p: int, hdim: int,
                     wdim: int) -> None:
    """Write src reflect-padded by p (no edge repeat, as ``F.pad(mode=
    "reflect")``) into dst, whose dims hdim and wdim are 2p longer than
    src's: one pass over src, then the borders, rows last so that they take
    the corners. p must be below both of src's spatial sizes."""
    h, w = src.shape[hdim], src.shape[wdim]
    rows = dst.narrow(hdim, p, h)
    rows.narrow(wdim, p, w).copy_(src)
    if p == 0:
        return
    rows.narrow(wdim, 0, p).copy_(src.narrow(wdim, 1, p).flip(wdim))
    rows.narrow(wdim, p + w, p).copy_(
        src.narrow(wdim, w - p - 1, p).flip(wdim))
    dst.narrow(hdim, 0, p).copy_(dst.narrow(hdim, p + 1, p).flip(hdim))
    dst.narrow(hdim, p + h, p).copy_(dst.narrow(hdim, h - 1, p).flip(hdim))


def pad_input(x: torch.Tensor, k: int,
              width: Optional[int] = None) -> torch.Tensor:
    """NHWC x -> (n, h + 2p + 1, width * cin): reflect pad by p = k // 2,
    zeros in the columns past w + 2p up to `width` (default w + 2p: none)
    and one zero row below (the TPU kernels' last chunk reads into it), each
    padded row one flat run; written in one pass over x. K5 reads it at w +
    2p, K6 at its Wp."""
    n, h, wd, cin = x.shape
    p = k // 2
    width = wd + 2 * p if width is None else width
    if width < wd + 2 * p:
        raise ValueError(f"pad_input: width {width} is below w + 2p = "
                         f"{wd + 2 * p}")
    xp = x.new_empty((n, h + 2 * p + 1, width, cin))
    reflect_pad_into(xp[:, :h + 2 * p, :wd + 2 * p], x, p, 1, 2)
    xp[:, :h + 2 * p, wd + 2 * p:].zero_()
    xp[:, h + 2 * p].zero_()
    return xp.view(n, h + 2 * p + 1, width * cin)


def reflect_conv_reference(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version of the three conv prototypes' function: the reflect pad
    of NHWC x, then ``F.conv2d`` in float32 with HWIO w, then one rounding to
    x's dtype; NHWC out. On the card the caller turns TF32 off
    (``resolve_device``)."""
    p = w.shape[0] // 2
    xp = F.pad(x.permute(0, 3, 1, 2).float(), (p, p, p, p), mode="reflect")
    y = F.conv2d(xp, w.permute(3, 2, 0, 1).float())
    return y.permute(0, 2, 3, 1).to(x.dtype).contiguous()


def conv_operands(batch: int, s: int, cin: int, cout: int, k: int,
                  device: torch.device, dtype: torch.dtype, seed: int = 0):
    """The scripts' operands: x (batch, s, s, cin) standard normal and w
    (k, k, cin, cout) 0.05 x standard normal, from one seed, drawn on
    `device`."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((batch, s, s, cin), generator=g, device=device)
    w = torch.randn((k, k, cin, cout), generator=g, device=device) * 0.05
    return x.to(dtype), w.to(dtype)


def conv_gflop(batch: int, s: int, cin: int, cout: int, k: int) -> float:
    return 2 * s * s * cin * cout * k * k * batch / 1e9
