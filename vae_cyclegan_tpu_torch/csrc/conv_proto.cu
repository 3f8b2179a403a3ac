// K5: the reflect-padded SAME stride-1 conv forward of the NHWC prototype,
// on the NHWC conv core (nhwc_conv.cuh) with its padded-input loader.
//
// Replaces experiments/pallas_conv_proto.py::pallas_reflect_conv_fwd (kernel
// body _kernel): per (image, R-row chunk) the TPU kernel DMAs the chunk's
// padded rows into VMEM, concatenates the k*k taps into one (R*Wp, k*k*cin)
// patch matrix and does one MXU matmul, K ordered (dy, dx, ci). The wrapper
// (vae_cyclegan_tpu_torch/experiments/conv_proto.py) reflect-pads the NHWC
// input by p = k/2 and adds one zero row, as the TPU wrapper does in XLA:
// xp (n, h + 2p + 1, (w + 2p) * cin), each padded row one flat run. So for
// cin * 2 bytes a multiple of 16 the slab is filled by plain 16-byte
// cp.async copies of those runs (zeros past a row's end); the head's 3
// channels take the core's raw-row path. R only keeps its check: the card's
// tiles are two output rows of 256 (U4, the head) or 64 (U3) columns, four
// of 64 for the folded tail (the TPU's chunks are R rows of every column).
// The contraction order stays (dy, dx, ci); the tail (cout 3) folds its dx
// taps into N.
//
// What bounds it (bf16, batch 24; NVIDIA H100 80GB HBM3 at 3.35 TB/s and 989
// TFLOP/s): the head k7 3->64 @256 and the tail k7 64->3 @256 by bytes
// (211 MB: 0.0629 ms), U4 k3 32->64 @256 by bytes (302 MB: 0.0901 ms), U3 k3
// 64->128 @128 by the tensor cores (58.0 GFLOP: 0.0586 ms); the padded copy
// (pad_input) is one more pass over x. The first port ran at 6-35x these
// bounds: its K loop gathered every fragment pair through a koff table
// (about three shared loads per mma), staged each tile's slab through
// registers between two barriers with nothing overlapping it, wrote 2-byte
// NHWC stores 'cout' elements apart, and ran the tail with 13 of 16 mma
// columns idle over K = 3136. The core's answers are in nhwc_conv.cuh:
// ldmatrix.x4 fragments from a slab at an odd chunk stride, a two-slab
// cp.async ring walked by persistent blocks, 16-byte NHWC stores from a
// staged tile, and the dx fold for the tail. Its times per shape, beside
// these bounds, are in PERF.md (chip_smoke.py's experiments phase).

#include "nhwc_conv.cuh"

namespace {

template <typename T, int R, int BM, int BN, int WARPS_M, bool FOLD>
__global__ void __launch_bounds__(vct::nhwc::kThreads, 1)
    conv_proto_nhwc_kernel(const T* __restrict__ xp, const T* __restrict__ wk,
                           T* __restrict__ y, vct::nhwc::Shape s) {
  vct::nhwc::conv_body<T, R, BM, BN, WARPS_M, FOLD,
                       vct::nhwc::Source::kPadded>(xp, wk, y, s);
}

struct K5 {
  static constexpr vct::nhwc::Source kSource = vct::nhwc::Source::kPadded;
  static constexpr bool kDxOuter = false;  // K = (dy, dx, ci)
  template <typename T, int R, int BM, int BN, int WARPS_M, bool FOLD>
  static auto get() {
    return conv_proto_nhwc_kernel<T, R, BM, BN, WARPS_M, FOLD>;
  }
};

}  // namespace

// xp: contiguous (n, h + 2p + 1, (w + 2p) * cin), the reflect-padded input
// with one extra zero row; wk: contiguous, of the same type, the weight
// (k, k, cin, cout) with cin zero-padded to cin_s (a whole number of 16-byte
// chunks: 8 bf16, 4 f32) as the rows (cout, k * k * cin_s), K ordered (dy,
// dx, ci); where `fold` (k * cout <= 32) the rows (cout * k, k * cin_s), row
// co * k + dx, K ordered (dy, ci); y: contiguous (n, h, w, cout). dtype:
// vct::kFloat32 or vct::kBFloat16. Requires odd k and k/2 < min(h, w); a
// block's weights and two slabs must fit shared memory (227 KB). Returns the
// cudaError_t of the launch (0 = success).
extern "C" int vct_conv_proto(const void* xp, const void* wk, void* y, int n,
                              int h, int wd, int cin, int cout, int k,
                              int fold, int dtype, void* stream) {
  return vct::nhwc::entry<K5>(xp, wk, y, n, h, wd, cin, cout, k, fold, dtype,
                              stream);
}
