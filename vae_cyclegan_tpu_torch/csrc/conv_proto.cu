// Reflect-padded SAME stride-1 conv forward of the NHWC prototype: an
// implicit GEMM per (image, R-row chunk), rows = the chunk's output
// positions, columns = cout, K = k*k*cin.
//
// Replaces experiments/pallas_conv_proto.py::pallas_reflect_conv_fwd (kernel
// body _kernel). The wrapper (vae_cyclegan_tpu_torch/experiments/
// conv_proto.py) reflect-pads the NHWC input by p = k/2 and adds one zero row,
// as the TPU wrapper does in XLA, giving xp (n, h + 2p + 1, Wp * cin) with
// Wp = w + 2p: each padded row is one flat run of Wp * cin elements. The
// weight is w (k, k, cin, cout) read as the matrix (k*k*cin, cout).
//
// The TPU kernel DMAs a chunk's R + 2p + 1 padded rows into VMEM, relayouts
// them to (rows * Wp, cin) so that tap (dy, dx) of flat position q is row
// q + dy*Wp + dx, concatenates the k*k taps into one (R*Wp, k*k*cin) patch
// matrix and does one MXU matmul. Here a block owns BN output channels,
// whose weights it keeps in shared memory, and walks several tiles of BM
// output columns of one output row. Per tile it copies the k padded rows
// under it, BM + 2p columns, into shared memory (the slab, each column's
// channels padded to cin_s, cin_s = 8 mod 16, so the mma fragment loads
// below hit distinct banks); then patch-matrix element (c, (dy*k + dx) *
// cin_g + ci) is slab element ((dy * (BM + 2p) + c + dx) * cin_s + ci), and
// the K loop reads its mma fragments straight from the slab and the weights,
// with no barrier in it. Each input element is read from device memory k
// times (once per output row that uses it) instead of k*k. cin_g is cin
// rounded up to even (the head's 3 channels become 4, the fourth with zero
// weights), so each contraction pair is one aligned word. The TPU kernel
// also computes the 2p wrap-around columns of each row and slices them off
// in XLA; this one computes the w real columns and writes NHWC
// y (n, h, w, cout) directly.
//
// What bounds it: at batch 24 the four shapes of the prototype move 0.15-0.30
// GB of bf16 and do 29.6-58.0 GFLOP: bound by bytes at the k7 head and tail
// and at U4 (0.06-0.09 ms at 3.35 TB/s), by the tensor cores at U3
// (0.059 ms). This version reads its input k times and its fragments with
// 4-byte shared-memory loads (mma.sync, not wgmma); TMA loads of the slab,
// wgmma, and overlapping one tile's slab copy with the last one's products
// are later steps.

#include <climits>

#include "igemm.cuh"

namespace {

using vct::igemm::align16;
using vct::igemm::kThreads;

template <typename T, int BM, int BN, int WARPS_M>
__global__ void __launch_bounds__(kThreads)
    conv_proto_kernel(const T* __restrict__ xp, const T* __restrict__ wt,
                      T* __restrict__ y, int h, int wd, int cin, int cin_g,
                      int cin_s, int cout, int k, int R, int tiles_w,
                      int tiles_n, int tpb) {
  using Tl = vct::igemm::Tile<T, BM, BN, WARPS_M>;
  const int K = k * k * cin_g, kpad = (K + 15) / 16 * 16;
  const int ws = kpad + 8;   // weight row stride: 8 mod 16, distinct banks
  const int sp = BM + k - 1;  // slab columns
  const int wp = wd + k - 1;
  const int nt = blockIdx.x % tiles_n;
  const int n0 = nt * BN, nreal = min(BN, cout - n0);
  const int chunks = h / R;
  const int img = blockIdx.y / chunks;
  const int row0 = (blockIdx.y - img * chunks) * R;
  const int tid = threadIdx.x;

  // shared memory: weights [nreal][ws] | koff [kpad / 2] | slab [k][sp][cin_s]
  extern __shared__ __align__(16) unsigned char smem[];
  T* wsm = reinterpret_cast<T*>(smem);
  int* koff = reinterpret_cast<int*>(smem + align16(sizeof(T) * nreal * ws));
  T* slab = reinterpret_cast<T*>(reinterpret_cast<unsigned char*>(koff) +
                                 align16(sizeof(int) * (kpad / 2)));

  // the weights: rows n0 .. n0 + nreal - 1 of wt (cout, K), zeros to ws
  vct::igemm::copy_rows(
      wsm, nreal, ws,
      K * sizeof(T) % 16 == 0 && reinterpret_cast<uintptr_t>(wt) % 16 == 0,
      [&](int r) { return wt + (long long)(n0 + r) * K; },
      [&](int) { return K; });
  // the slab offset of each contraction pair (k, k + 1), k even
  for (int q = tid; q < kpad / 2; q += kThreads) {
    const int kk = 2 * q;
    int off = 0;
    if (kk < K) {
      const int tap = kk / cin_g, ci = kk - tap * cin_g;
      const int dy = tap / k, dx = tap - dy * k;
      off = (dy * sp + dx) * cin_s + ci;
    }
    koff[q] = off;
  }
  const vct::igemm::Slab<T, true> a{slab, koff, cin_s, 1};
  const vct::igemm::Rows<T> b{wsm, ws, nreal - 1};

  const T* src = xp + (long long)img * (h + k) * wp * cin;
  const bool vec = cin * sizeof(T) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(xp) % 16 == 0;
  const int mt = R * tiles_w;
  const int t1 = min(mt, (blockIdx.x / tiles_n + 1) * tpb);
  for (int t = (blockIdx.x / tiles_n) * tpb; t < t1; ++t) {
    const int r = row0 + t / tiles_w, c0 = (t % tiles_w) * BM;
    __syncthreads();  // every warp is done with the last tile's slab
    // padded rows r .. r + k - 1, columns c0 .. c0 + sp - 1 (zeros past Wp)
    vct::igemm::copy_rows(
        slab, k * sp, cin_s, vec,
        [&](int rr) {
          const int dy = rr / sp;
          return src + ((long long)(r + dy) * wp + c0 + rr - dy * sp) * cin;
        },
        [&](int rr) { return c0 + rr % sp < wp ? cin : 0; });
    __syncthreads();
    float acc[Tl::ACC];
#pragma unroll
    for (int i = 0; i < Tl::ACC; ++i) acc[i] = 0.f;
    Tl::mac(acc, a, b, kpad);
    T* out = y + ((long long)img * h + r) * wd * cout;
    Tl::each(acc, [&](int m, int n, float v) {
      const int c = c0 + m, co = n0 + n;
      if (c < wd && co < cout)
        out[(long long)c * cout + co] = vct::igemm::from_f<T>(v);
    });
  }
}

template <typename T, int BM, int BN, int WARPS_M>
cudaError_t run(const void* xp, const void* wt, void* y, int n, int h, int wd,
                int cin, int cout, int k, int R, cudaStream_t stream) {
  const int cin_g = (cin + 1) / 2 * 2;
  // cin_g rounded up to 8 mod 16: the fragment rows of a warp, one slab
  // column apart, then start in distinct banks
  int cin_s = (cin_g + 7) / 8 * 8;
  if (cin_s % 16 == 0) cin_s += 8;
  const int K = k * k * cin_g, kpad = (K + 15) / 16 * 16;
  const int tiles_w = (wd + BM - 1) / BM;
  const int tiles_n = (cout + BN - 1) / BN;
  const long long groups = (long long)n * (h / R);
  const long long mt = (long long)R * tiles_w;
  const int tpb = vct::igemm::tiles_per_block(groups * tiles_n * mt);
  const long long blocks = tiles_n * ((mt + tpb - 1) / tpb);
  if (blocks > INT_MAX || groups > 65535) return cudaErrorInvalidValue;
  const size_t smem = align16(sizeof(T) * min(BN, cout) * (kpad + 8)) +
                      align16(sizeof(int) * (kpad / 2)) +
                      sizeof(T) * (size_t)k * (BM + k - 1) * cin_s;
  return vct::igemm::launch(conv_proto_kernel<T, BM, BN, WARPS_M>,
                            dim3((unsigned)blocks, (unsigned)groups), smem,
                            stream, static_cast<const T*>(xp),
                            static_cast<const T*>(wt), static_cast<T*>(y), h,
                            wd, cin, cin_g, cin_s, cout, k, R, tiles_w,
                            tiles_n, tpb);
}

template <typename T>
cudaError_t dispatch(const void* xp, const void* wt, void* y, int n, int h,
                     int wd, int cin, int cout, int k, int R,
                     cudaStream_t stream) {
  // few output channels (the k7 tail's 3): narrow tiles
  if (cout <= 16)
    return run<T, 64, 16, 4>(xp, wt, y, n, h, wd, cin, cout, k, R, stream);
  return run<T, 64, 64, 2>(xp, wt, y, n, h, wd, cin, cout, k, R, stream);
}

}  // namespace

// xp: contiguous (n, h + 2p + 1, (w + 2p) * cin), the reflect-padded input
// with one extra zero row; wt: contiguous (cout, k * k * cin_g) of the same
// type, the weight (k, k, cin, cout) with cin zero-padded to cin_g = cin
// rounded up to even, transposed; y: contiguous (n, h, w, cout). dtype:
// vct::kFloat32 or vct::kBFloat16. Requires odd k, k/2 < min(h, w), R
// dividing h, n * h / R <= 65535, and 64 (or, for cout <= 16, 16) output
// channels' weights and a slab of k * (64 + k - 1) columns that fit shared
// memory together (227 KB). Returns the cudaError_t of the launch (0 =
// success).
extern "C" int vct_conv_proto(const void* xp, const void* wt, void* y, int n,
                              int h, int wd, int cin, int cout, int k, int R,
                              int dtype, void* stream) {
  if (n <= 0 || h <= 0 || wd <= 0 || cin <= 0 || cout <= 0 || k <= 0 ||
      k % 2 == 0 || k / 2 >= h || k / 2 >= wd || R <= 0 || h % R != 0 ||
      (long long)k * k * (cin + 1) > INT_MAX / 4)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == vct::kFloat32)
    return (int)dispatch<float>(xp, wt, y, n, h, wd, cin, cout, k, R, s);
  if (dtype == vct::kBFloat16)
    return (int)dispatch<__nv_bfloat16>(xp, wt, y, n, h, wd, cin, cout, k, R, s);
  return (int)cudaErrorInvalidValue;
}
