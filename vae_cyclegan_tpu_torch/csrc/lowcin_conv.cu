// K6: reflect-padded SAME stride-1 conv forward of the channel-major
// prototype: per (image, R-row chunk), k dx-shifted GEMMs acc(cout, R*Wp) +=
// W[dx] (cout, k*cin_p) . patch[:, dx : dx + R*Wp], f32 accumulation, into
// the channel-major y (n, cout, h * Wp), all Wp columns of each row, as
// experiments/pallas_conv2.py::lowcin_conv writes it (its wrapper slices the
// w real columns and transposes to NHWC). This kernel also had an NHWC mode
// for K7 (experiments/pallas_conv3.py::lowcin_conv); K7 now runs on the NHWC
// conv core (lowcin_nhwc.cu), reading NHWC x with no channel-major copy, so
// the mode went with its last caller.
//
// Replaces experiments/pallas_conv2.py::lowcin_conv (kernel body _kernel).
// The wrapper
// (vae_cyclegan_tpu_torch/experiments/lowcin_conv2.py::prep_x, prep_w) lays
// the input out channel-major as the TPU wrapper does: xf (n, cin_p, xlen),
// each channel the reflect-padded (h + 2p) x Wp plane flattened, with cin
// zero-padded to cin_p and at least 2p zero elements after the last row; the
// weight as wdx (k_dx, cout, k_dy * cin_p). The TPU's tile sizes (cin_p a
// multiple of 8 sublanes, Wp of 128 lanes) become the card's: cin_p a
// multiple of 8 (16 bytes of bf16) and Wp = w + 2p rounded up to 8.
//
// The TPU kernel DMAs k overlapping row slabs per chunk into a patch
// (k*cin_p, L + 128) and takes the dx taps as lane-shifted slices of it.
// Here a block owns BM output channels, whose weights (the rows of wdx as
// one (cout, k*k*cin_p) matrix) it keeps in shared memory, and walks several
// tiles of BN consecutive flat positions l = r*Wp + c of a chunk. Per tile it
// copies the k*cin_p runs of BN + 2p elements under them (channel ci, tap
// row dy) into shared memory (the slab; each run rounded up to 16 bytes), and
// contraction index (dx, dy, ci) -> dx * k*cin_p + dy * cin_p + ci (the k dx
// GEMMs in order) of position l is slab element (ci*k + dy) * S + dx + l - l0.
// The K loop reads its mma fragments straight from the weights and the slab,
// with no barrier in it (a B fragment's pair, channels ci and ci + 1, is two
// 2-byte loads k*S apart); one tile's slab copy does not overlap the last
// tile's products.
//
// What bounds it: as conv_proto.cu, the same convs (bytes at the head, U4 and
// tail, the tensor cores at U3). This version reads its input k times, and
// the wrapper's channel-major copy in (prep_x) and the slice and transpose
// out are device-memory passes of their own.

#include <climits>

#include "igemm.cuh"

namespace {

using vct::igemm::align16;
using vct::igemm::kThreads;

template <typename T, int BM, int BN, int WARPS_M>
__global__ void __launch_bounds__(kThreads)
    lowcin_kernel(const T* __restrict__ xf, const T* __restrict__ wk,
                  T* __restrict__ y, int h, int wd, int wp, long long xlen,
                  int cin_p, int cout, int k, int R, int tiles_m, int tpb) {
  using Tl = vct::igemm::Tile<T, BM, BN, WARPS_M>;
  const int kcp = k * cin_p, K = k * kcp, kpad = (K + 15) / 16 * 16;
  const int ws = kpad + 8;                     // weight row stride: 8 mod 16
  const int sp = (BN + k - 1 + 7) / 8 * 8;     // slab run stride, 16-byte runs
  const int L = R * wp;                        // positions of a chunk
  const int mtile = blockIdx.x % tiles_m;
  const int m0 = mtile * BM, mreal = min(BM, cout - m0);
  const int chunks = h / R;
  const int img = blockIdx.y / chunks;
  const int row = (blockIdx.y - img * chunks) * R;  // the chunk's first row
  const int tid = threadIdx.x;

  // shared memory: weights [mreal][ws] | koff [kpad / 2] | slab [cin_p][k][sp]
  extern __shared__ __align__(16) unsigned char smem[];
  T* wsm = reinterpret_cast<T*>(smem);
  int* koff = reinterpret_cast<int*>(smem + align16(sizeof(T) * mreal * ws));
  T* slab = reinterpret_cast<T*>(reinterpret_cast<unsigned char*>(koff) +
                                 align16(sizeof(int) * (kpad / 2)));

  // the weights: rows m0 .. m0 + mreal - 1 of wk (cout, K), zeros to ws
  vct::igemm::copy_rows(
      wsm, mreal, ws,
      K * sizeof(T) % 16 == 0 && reinterpret_cast<uintptr_t>(wk) % 16 == 0,
      [&](int r) { return wk + (long long)(m0 + r) * K; },
      [&](int) { return K; });
  // the slab offset of each contraction pair (k, k + 1), k even: channels
  // ci and ci + 1 (cin_p is even) of tap (dy, dx)
  for (int q = tid; q < kpad / 2; q += kThreads) {
    const int kk = 2 * q;
    int off = 0;
    if (kk < K) {
      const int dx = kk / kcp, j = kk - dx * kcp;
      const int dy = j / cin_p, ci = j - dy * cin_p;
      off = (ci * k + dy) * sp + dx;
    }
    koff[q] = off;
  }
  const vct::igemm::Rows<T> a{wsm, ws, mreal - 1};
  const vct::igemm::Slab<T> b{slab, koff, 1, k * sp};

  const T* src = xf + (long long)img * cin_p * xlen + (long long)row * wp;
  const bool vec = wp * sizeof(T) % 16 == 0 && xlen * sizeof(T) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(xf) % 16 == 0;
  const int mt = (L + BN - 1) / BN;
  const int t1 = min(mt, (blockIdx.x / tiles_m + 1) * tpb);
  for (int t = (blockIdx.x / tiles_m) * tpb; t < t1; ++t) {
    const int l0 = t * BN;
    __syncthreads();  // every warp is done with the last tile's slab
    // run (ci, dy) = xf[ci][(row + dy) * Wp + l0 + e], zeros past the
    // channel's end (positions past the chunk)
    const long long left = xlen - (long long)row * wp - l0;
    vct::igemm::copy_rows(
        slab, cin_p * k, sp, vec,
        [&](int rr) {
          const int ci = rr / k;
          return src + (long long)ci * xlen + (long long)(rr - ci * k) * wp + l0;
        },
        [&](int rr) {
          return (int)min((long long)sp, left - (long long)(rr % k) * wp);
        });
    __syncthreads();
    float acc[Tl::ACC];
#pragma unroll
    for (int i = 0; i < Tl::ACC; ++i) acc[i] = 0.f;
    Tl::mac(acc, a, b, kpad);
    Tl::each(acc, [&](int m, int n, float v) {
      const int co = m0 + m, l = l0 + n;
      if (co >= cout || l >= L) return;
      y[((long long)img * cout + co) * h * wp + (long long)row * wp + l] =
          vct::igemm::from_f<T>(v);
    });
  }
}

template <typename T, int BM, int BN, int WARPS_M>
cudaError_t run(const void* xf, const void* wk, void* y, int n, int h, int wd,
                int cin_p, int cout, int k, int R, int wp, long long xlen,
                cudaStream_t stream) {
  const int K = k * k * cin_p, kpad = (K + 15) / 16 * 16;
  const int tiles_m = (cout + BM - 1) / BM;
  const long long groups = (long long)n * (h / R);
  const long long mt = ((long long)R * wp + BN - 1) / BN;
  const int tpb = vct::igemm::tiles_per_block(groups * tiles_m * mt);
  const long long blocks = tiles_m * ((mt + tpb - 1) / tpb);
  if (blocks > INT_MAX || groups > 65535) return cudaErrorInvalidValue;
  const size_t smem = align16(sizeof(T) * min(BM, cout) * (kpad + 8)) +
                      align16(sizeof(int) * (kpad / 2)) +
                      sizeof(T) * (size_t)cin_p * k * ((BN + k - 1 + 7) / 8 * 8);
  return vct::igemm::launch(lowcin_kernel<T, BM, BN, WARPS_M>,
                            dim3((unsigned)blocks, (unsigned)groups), smem,
                            stream, static_cast<const T*>(xf),
                            static_cast<const T*>(wk), static_cast<T*>(y), h,
                            wd, wp, xlen, cin_p, cout, k, R, tiles_m, tpb);
}

template <typename T>
cudaError_t dispatch(const void* xf, const void* wk, void* y, int n, int h,
                     int wd, int cin_p, int cout, int k, int R, int wp,
                     long long xlen, cudaStream_t stream) {
  // few output channels (the k7 tail's 3): short tiles
  if (cout <= 16)
    return run<T, 16, 64, 1>(xf, wk, y, n, h, wd, cin_p, cout, k, R, wp, xlen,
                             stream);
  return run<T, 64, 64, 2>(xf, wk, y, n, h, wd, cin_p, cout, k, R, wp, xlen,
                           stream);
}

}  // namespace

// xf: contiguous (n, cin_p, xlen); wk: contiguous (cout, k * k * cin_p) of the
// same type, row co = wdx[:, co, :] of the (k, cout, k * cin_p) weight, dx
// major; y: contiguous (n, cout, h * wp). dtype: vct::kFloat32 or
// vct::kBFloat16. Requires odd k, even cin_p, k/2 < min(h, w), wp >= w + k - 1, xlen >= (h + k - 1) * wp + k - 1 (the
// last chunk's taps), R dividing h, n * h / R <= 65535, and 64 (or, for
// cout <= 16, 16) output channels' weights and a slab of cin_p * k runs of
// 64 + k - 1 (rounded up to 8) elements that fit shared memory together
// (227 KB). Returns the cudaError_t of the launch (0 = success).
extern "C" int vct_lowcin_conv(const void* xf, const void* wk, void* y, int n,
                               int h, int wd, int cin_p, int cout, int k,
                               int R, int wp, long long xlen, int dtype,
                               void* stream) {
  if (n <= 0 || h <= 0 || wd <= 0 || cin_p <= 0 || cin_p % 2 != 0 ||
      cout <= 0 || k <= 0 || k % 2 == 0 || k / 2 >= h || k / 2 >= wd ||
      R <= 0 || h % R != 0 || wp < wd + k - 1 ||
      xlen < (long long)(h + k - 1) * wp + k - 1 ||
      (long long)R * wp > INT_MAX / 2 || (long long)k * k * cin_p > INT_MAX / 4)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == vct::kFloat32)
    return (int)dispatch<float>(xf, wk, y, n, h, wd, cin_p, cout, k, R, wp,
                                xlen, s);
  if (dtype == vct::kBFloat16)
    return (int)dispatch<__nv_bfloat16>(xf, wk, y, n, h, wd, cin_p, cout, k,
                                        R, wp, xlen, s);
  return (int)cudaErrorInvalidValue;
}
