// K7: the low-cin conv prototype with NHWC output, on the NHWC conv core
// (nhwc_conv.cuh) with the reflect halo computed in its loader.
//
// Replaces experiments/pallas_conv3.py::lowcin_conv (kernel body _kernel):
// K6's math (k dx-shifted GEMMs, K ordered dx outermost, then (dy, ci)) on
// one flat grid over (image, chunk), with the next chunk's slab DMAs double-
// buffered and the NHWC output written by the kernel. The TPU kernel takes a
// channel-major input, laid out by its wrapper for the TPU's (8, 128) lane
// tiling; pallas_conv3.py exists to remove relayouts. On this card that
// layout is a device-memory pass that buys nothing, so this kernel reads the
// NHWC x itself: each 16-byte (position, 8-channel) chunk of the slab is
// copied by cp.async from its reflected source position (row and column
// reflected by p = k/2, no padded copy); the head's 3 channels take the
// core's raw-row path. The flat grid becomes the core's persistent blocks,
// and the double buffer its two-slab cp.async ring. R only keeps its check:
// the card's tiles are two output rows of 256 (U4, the head) or 64 (U3)
// columns.
//
// What bounds it (bf16, batch 24; NVIDIA H100 80GB HBM3 at 3.35 TB/s and 989
// TFLOP/s): the head k7 3->64 @256 by bytes (211 MB: 0.0629 ms), U4 k3
// 32->64 @256 by bytes (302 MB: 0.0901 ms), U3 k3 64->128 @128 by the tensor
// cores (58.0 GFLOP: 0.0586 ms). The first port (lowcin_conv.cu's NHWC
// mode) ran at 13-26x these bounds: a channel-major copy of x per call
// (0.22 ms at U3 and U4), every B fragment pair gathered as two 2-byte
// shared loads, no overlap of a tile's slab copy with the products, and
// 2-byte NHWC stores 'cout' elements apart. See nhwc_conv.cuh for what the
// core does about each, and PERF.md for its times per shape beside these
// bounds (chip_smoke.py's experiments phase).

#include "nhwc_conv.cuh"

namespace {

template <typename T, int R, int BM, int BN, int WARPS_M, bool FOLD>
__global__ void __launch_bounds__(vct::nhwc::kThreads, 1)
    lowcin_nhwc_kernel(const T* __restrict__ x, const T* __restrict__ wk,
                       T* __restrict__ y, vct::nhwc::Shape s) {
  vct::nhwc::conv_body<T, R, BM, BN, WARPS_M, FOLD,
                       vct::nhwc::Source::kReflect>(x, wk, y, s);
}

struct K7 {
  static constexpr vct::nhwc::Source kSource = vct::nhwc::Source::kReflect;
  static constexpr bool kDxOuter = true;  // K = (dx, dy, ci)
  template <typename T, int R, int BM, int BN, int WARPS_M, bool FOLD>
  static auto get() {
    return lowcin_nhwc_kernel<T, R, BM, BN, WARPS_M, FOLD>;
  }
};

}  // namespace

// x: contiguous NHWC (n, h, w, cin); wk: contiguous, of the same type, the
// weight (k, k, cin, cout) with cin zero-padded to cin_s (a whole number of
// 16-byte chunks: 8 bf16, 4 f32) as the rows (cout, k * k * cin_s), K ordered
// (dx, dy, ci); where `fold` (k * cout <= 32) the rows (cout * k, k * cin_s),
// row co * k + dx, K ordered (dy, ci); y: contiguous (n, h, w, cout). dtype:
// vct::kFloat32 or vct::kBFloat16. Requires odd k and k/2 < min(h, w); a
// block's weights and two slabs must fit shared memory (227 KB). Returns the
// cudaError_t of the launch (0 = success).
extern "C" int vct_lowcin_nhwc(const void* x, const void* wk, void* y, int n,
                               int h, int wd, int cin, int cout, int k,
                               int fold, int dtype, void* stream) {
  return vct::nhwc::entry<K7>(x, wk, y, n, h, wd, cin, cout, k, fold, dtype,
                              stream);
}
