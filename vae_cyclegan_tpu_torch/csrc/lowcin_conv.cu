// K6: the channel-major low-cin conv prototype, on the NHWC conv core
// (nhwc_conv.cuh) with its flat Wp-wide loader and channel-major epilogue.
//
// Replaces experiments/pallas_conv2.py::lowcin_conv (kernel body _kernel):
// per (image, R-row chunk) the TPU kernel DMAs k overlapping row slabs of
// the channel-major padded input (n, cin_p, (h + 2p) * Wp + tail) into a
// patch and computes acc(cout, R*Wp) += W[dx] (cout, k*cin_p) .
// patch[:, dx : dx + R*Wp] for dx in order, f32 accumulation and one
// rounding, into the channel-major y (n, cout, h * Wp): every Wp column of
// each row, the columns past w wrapping into the next padded row (its
// wrapper slices them away). This kernel keeps that contract and its
// contraction order, (dx, dy, ci).
//
// The input: the wrapper (vae_cyclegan_tpu_torch/experiments/
// lowcin_conv2.py) writes the reflect-padded NHWC copy Wp wide, (n, h + 2p +
// 1, Wp * cin), zeros in columns w + 2p .. Wp - 1 and in the last row
// (experiments/common.py::pad_input, one pass over x); it holds the TPU
// layout's values position-major instead of channel-major, so the 16-byte
// (position, 8-channel) chunks of the core's slab are plain cp.async copies.
// A slab row is the flat run from (r0 + dy) * Wp + c0 and continues across
// the row's end as the TPU's flat lanes do: the wrap columns read the next
// row, and the last row's taps read the zero row. The head's 3 channels
// take the core's raw-row path, each raw run taken whole across row ends.
// The TPU's tile sizes become the card's: Wp = w + 2p rounded up to 8 (128
// there), cin zero-filled to 16-byte chunks in the slab (8 sublanes there).
//
// The tiles: the core's (nhwc_conv.cuh dispatch): 2 x 256 by 64 at the head
// and U4, 2 x 64 by 128 at U3, 4 x 64 by 32 with the tail's dx taps folded
// into N. At Wp = 264 (the 256-wide shapes) a band of two rows is a tile of
// 256 columns and 8 left over, at U3 (Wp = 136) two of 64 and 8. No BM that
// is a multiple of 16 divides 264 or 136, and narrower tiles lose what the
// wide ones were chosen for (the copy and store phases spread over more
// outputs). As ragged tiles of 8 columns, the leftovers cost half a whole
// tile each however little of it they copy, compute and store (their
// fixed phases, and a K loop of one fragment in two warps that hides no
// latency; timed with the phases skipped in turn). So the core gives them
// to strip tiles, 64 rows x 8 columns at the head and U4 (16 x 8 at U3), a
// whole tile's M each: 96 strip tiles beside the head's 3072 whole ones in
// place of 3072 ragged ones. The folded tail's tile is 56 output columns
// (64 - k + 1, down to a multiple of 8, so that each channel's run starts
// on 16 bytes): five per band of four rows, the last one 40 wide.
//
// The output: the tile is staged per channel in shared memory (stmatrix
// .trans: each stored row 8 positions of one channel), and each
// (channel, tile row) run of positions goes out in 16-byte stores (Wp, the
// tiles' first columns and widths are multiples of 8); the folded tail sums
// each co over its dx-shifted positions, dx ascending, in f32, rounds once,
// then stores the same way. No atomics: a launch repeats bit for bit.
//
// What bounds it (bf16, batch 24; NVIDIA H100 80GB HBM3 at 3.35 TB/s and 989
// TFLOP/s), counting every Wp column of y: the head k7 3->64 @256 and the
// tail k7 64->3 @256 by bytes (x read once, y written once: 217 and 211 MB,
// 0.065 and 0.063 ms), U4 k3 32->64 @256 by bytes (308 MB: 0.092 ms), U3 k3
// 64->128 @128 by the tensor cores (61.6 GFLOP over its Wp = 136 columns:
// 0.062 ms); the padded copy is one more pass over x. The first port (on
// igemm.cuh) ran at ~25x these bounds: it read its input k times from a
// channel-major copy made on every call, gathered each B fragment pair as
// two 2-byte shared loads, and copied a tile's slab with nothing
// overlapping it. What still holds this design back is the core's
// (nhwc_conv.cuh, PERF.md): the K loop bound by ldmatrix traffic on
// mma.sync, and the copy and store phases beside it; the 8-column tiles,
// the wrap columns (3% of the output) and the padded copy add to K5's time
// at the same shapes. Its times per shape are in PERF.md (chip_smoke.py's
// experiments phase).

#include "nhwc_conv.cuh"

namespace {

template <typename T, int R, int BM, int BN, int WARPS_M, bool FOLD>
__global__ void __launch_bounds__(vct::nhwc::kThreads, 1)
    lowcin_cm_kernel(const T* __restrict__ xp, const T* __restrict__ wk,
                     T* __restrict__ y, vct::nhwc::Shape s) {
  vct::nhwc::conv_body<T, R, BM, BN, WARPS_M, FOLD, vct::nhwc::Source::kFlat>(
      xp, wk, y, s);
}

struct K6 {
  static constexpr vct::nhwc::Source kSource = vct::nhwc::Source::kFlat;
  static constexpr bool kDxOuter = true;  // K = (dx, dy, ci)
  template <typename T, int R, int BM, int BN, int WARPS_M, bool FOLD>
  static auto get() {
    return lowcin_cm_kernel<T, R, BM, BN, WARPS_M, FOLD>;
  }
};

}  // namespace

// xp: contiguous (n, h + 2p + 1, wp * cin), the reflect-padded input wp
// columns wide, zeros past column w + 2p and in the last row; wk:
// contiguous, of the same type, the weight (k, k, cin, cout) with cin
// zero-padded to cin_s (a whole number of 16-byte chunks: 8 bf16, 4 f32) as
// the rows (cout, k * k * cin_s), K ordered (dx, dy, ci); where `fold` (k *
// cout <= 32) the rows (cout * k, k * cin_s), row co * k + dx, K ordered
// (dy, ci); y: contiguous (n, cout, h * wp), every wp column. dtype:
// vct::kFloat32 or vct::kBFloat16. Requires odd k, k/2 < min(h, w), and wp
// >= w + 2p, a multiple of 8 (4 in f32); a block's weights and two slabs
// must fit shared memory (227 KB). Returns the cudaError_t of the launch
// (0 = success).
extern "C" int vct_lowcin_conv(const void* xp, const void* wk, void* y, int n,
                               int h, int wd, int cin, int cout, int k,
                               int wp, int fold, int dtype, void* stream) {
  return vct::nhwc::entry<K6>(xp, wk, y, n, h, wd, cin, cout, k, fold, dtype,
                              stream, wp);
}
