// Weight gradient of the reflect-padded SAME convolution (stride 1, odd k):
//
//   dw[co, ci, dy, dx] = sum over (n, oh, ow) of
//       g[n, co, oh, ow] * x[n, ci, refl(oh + dy - k/2), refl(ow + dx - k/2)]
//
// NCHW x (n, cin, h, w) and g (n, cout, h, w) of one type (f32 or bf16), f32
// accumulation, f32 OIHW output (cout, cin, k, k).
//
// Replaces vae_cyclegan_tpu/ops/starved_conv.py::_dw_call (kernel body
// _dw_kernel): the weight gradients of the encoder head (k7, 3->64), the
// decoder's U4 (k3, 32->64) and tail (k7, 64->3), all at 256x256. Like the
// TPU kernel it reads x with the reflect halo resolved in the loader, so no
// padded copy of x is written to device memory.
//
// What bounds it: the reduction runs over n*h*w positions (262,144 per weight
// at batch 4): 2.5 G multiply-adds for the head and the tail, 4.8 G for U4,
// over 35-50 MB of bf16 input. At ~100-190 flop/byte that is FMA issue on
// the CUDA cores, not device memory; the weights themselves are tiny (9,408 or
// 18,432 floats). Tensor cores (a split-K GEMM of (cout x positions) by
// (positions x cin*k*k) through wgmma) are the later, faster design.
//
// Design: two passes, no atomics, so results repeat bit for bit.
//   1. Each block owns one band of rows of one image (a "slice" of the
//      positions), a chunk of output channels and a chunk of input channels.
//      Every thread owns one (ci, dy, co group) unit: CO_R output channels
//      times all k column taps, CO_R * k f32 accumulators in registers. The
//      block walks its band in 4x32 sub-tiles; per sub-tile it stages the
//      input tile with its reflected halo and the gradient tile in shared
//      memory as f32, then each thread sweeps the sub-tile four columns at a
//      time: one row segment of k+3 inputs and CO_R float4 gradients feed
//      4 * CO_R * k FMAs. At the end of its band each thread writes its sums
//      to its slice of an f32 scratch, partial[slice][co][ci][dy][dx].
//   2. One thread per weight sums the slices in slice order.
// The TPU kernel instead carries one accumulator across its sequential grid;
// Hopper's blocks run in no order, hence the second pass.

#include <algorithm>
#include <climits>

#include "common.cuh"

namespace {

constexpr int kTileH = 4;    // rows per sub-tile
constexpr int kTileW = 32;   // columns per sub-tile
constexpr int kVec = 4;      // consecutive columns per thread step
// gradient tile channel stride in floats: 16-byte aligned, and 33 (odd)
// 16-byte groups so that neighbouring channels fall in other banks
constexpr int kGStride = kTileH * kTileW + 4;
constexpr int kMaxThreads = 256;
constexpr int kTargetBlocks = 1024;
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr size_t kMaxSmem = 227 * 1024;
constexpr int kMaxK = 15;

__device__ __forceinline__ int reflect_index(int i, int n) {
  i = i < 0 ? -i : i;
  i = i >= n ? 2 * n - 2 - i : i;
  return min(max(i, 0), n - 1);
}

// How the work is cut; computed once on the host for both passes and for
// the scratch size the wrapper allocates.
struct Plan {
  int co_r;       // output channels per thread (4 or 8)
  int co_chunk;   // output channels per block
  int co_groups;  // co_chunk / co_r
  int co_chunks;
  int ci_chunk;   // input channels per block
  int ci_chunks;
  int units;      // ci_chunk * k * co_groups threads that own accumulators
  int rows;       // rows per band, a multiple of kTileH
  int bands;      // bands per image
  long long slices;
  size_t smem;
};

Plan make_plan(int n, int cin, int cout, int h, int k) {
  Plan p;
  p.co_r = cout <= 4 ? 4 : 8;
  p.co_chunk = std::min((cout + p.co_r - 1) / p.co_r * p.co_r, 64);
  p.co_groups = p.co_chunk / p.co_r;
  p.co_chunks = (cout + p.co_chunk - 1) / p.co_chunk;
  const int cap = std::max(1, kMaxThreads / (k * p.co_groups));
  p.ci_chunks = (cin + cap - 1) / cap;
  p.ci_chunk = (cin + p.ci_chunks - 1) / p.ci_chunks;
  p.units = p.ci_chunk * k * p.co_groups;
  const int row_tiles = (h + kTileH - 1) / kTileH;
  const long long per_band = (long long)n * p.co_chunks * p.ci_chunks;
  const int want = (int)std::min<long long>(
      row_tiles,
      std::max<long long>(1, (kTargetBlocks + per_band - 1) / per_band));
  p.rows = (row_tiles + want - 1) / want * kTileH;
  p.bands = (h + p.rows - 1) / p.rows;
  p.slices = (long long)n * p.bands;
  p.smem = sizeof(float) *
           ((size_t)p.co_chunk * kGStride +
            (size_t)p.ci_chunk * (kTileH + k - 1) * (kTileW + k - 1));
  return p;
}

template <typename T, int KMAX, int CO_R>
__global__ void __launch_bounds__(kMaxThreads)
    dw_partial_kernel(const T* __restrict__ x, const T* __restrict__ g,
                      float* __restrict__ partial, int cin, int cout, int h,
                      int wd, int k, int ci_chunk, int co_chunk, int co_groups,
                      int units, int rows, int bands) {
  extern __shared__ __align__(16) float smem[];
  const int span_h = kTileH + k - 1;
  const int span_w = kTileW + k - 1;
  float* s_g = smem;                        // [co_chunk][kGStride]
  float* s_x = smem + co_chunk * kGStride;  // [ci_chunk][span_h][span_w]

  const int n = blockIdx.x / bands;
  const int band = blockIdx.x % bands;
  const int r_begin = band * rows;
  const int r_end = min(h, r_begin + rows);
  const int co0 = blockIdx.y * co_chunk;
  const int ci0 = blockIdx.z * ci_chunk;
  const int p = k / 2;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const long long plane = (long long)h * wd;

  // this thread's unit: input channel, row tap, group of output channels
  // (channels cg, cg + co_groups, ...: neighbouring threads read
  // neighbouring gradient channels)
  const int cg = tid % co_groups;
  const int dy = (tid / co_groups) % k;
  const int ci_l = tid / (co_groups * k);
  const bool owner = tid < units;

  float acc[CO_R][KMAX];
#pragma unroll
  for (int c = 0; c < CO_R; ++c)
#pragma unroll
    for (int d = 0; d < KMAX; ++d) acc[c][d] = 0.f;

  for (int r0 = r_begin; r0 < r_end; r0 += kTileH) {
    for (int c0 = 0; c0 < wd; c0 += kTileW) {
      __syncthreads();  // the previous sub-tile has been consumed
      for (int e = tid; e < co_chunk * kTileH * kTileW; e += nthreads) {
        const int c = e / (kTileH * kTileW);
        const int rem = e - c * (kTileH * kTileW);
        const int i = rem / kTileW;
        const int j = rem - i * kTileW;
        const int co = co0 + c;
        const int oh = r0 + i;
        const int ow = c0 + j;
        float v = 0.f;  // positions past the band or the image add nothing
        if (co < cout && oh < r_end && ow < wd)
          v = vct::load_f(g, ((long long)n * cout + co) * plane +
                                 (long long)oh * wd + ow);
        s_g[c * kGStride + rem] = v;
      }
      for (int e = tid; e < ci_chunk * span_h * span_w; e += nthreads) {
        const int c = e / (span_h * span_w);
        const int rem = e - c * (span_h * span_w);
        const int i = rem / span_w;
        const int j = rem - i * span_w;
        const int ci = ci0 + c;
        float v = 0.f;
        if (ci < cin) {
          const int row = reflect_index(r0 - p + i, h);
          const int col = reflect_index(c0 - p + j, wd);
          v = vct::load_f(x, ((long long)n * cin + ci) * plane +
                                 (long long)row * wd + col);
        }
        s_x[e] = v;
      }
      __syncthreads();
      if (!owner) continue;

      const float* xs = s_x + (ci_l * span_h + dy) * span_w;
      for (int i = 0; i < kTileH; ++i) {
        for (int j = 0; j < kTileW; j += kVec) {
          float xv[KMAX + kVec - 1];
#pragma unroll
          for (int t = 0; t < KMAX + kVec - 1; ++t)
            xv[t] = t < k + kVec - 1 ? xs[i * span_w + j + t] : 0.f;
#pragma unroll
          for (int c = 0; c < CO_R; ++c) {
            const float4 gv = *reinterpret_cast<const float4*>(
                s_g + (c * co_groups + cg) * kGStride + i * kTileW + j);
#pragma unroll
            for (int d = 0; d < KMAX; ++d) {
              float a = acc[c][d];
              a = fmaf(gv.x, xv[d], a);
              a = fmaf(gv.y, xv[d + 1], a);
              a = fmaf(gv.z, xv[d + 2], a);
              a = fmaf(gv.w, xv[d + 3], a);
              acc[c][d] = a;
            }
          }
        }
      }
    }
  }

  const int ci = ci0 + ci_l;
  if (!owner || ci >= cin) return;
  const long long wcount = (long long)cout * cin * k * k;
  float* out = partial + ((long long)n * bands + band) * wcount;
#pragma unroll
  for (int c = 0; c < CO_R; ++c) {
    const int co = co0 + c * co_groups + cg;
    if (co >= cout) continue;
#pragma unroll
    for (int d = 0; d < KMAX; ++d)
      if (d < k) out[(((long long)co * cin + ci) * k + dy) * k + d] = acc[c][d];
  }
}

__global__ void dw_reduce_kernel(const float* __restrict__ partial,
                                 float* __restrict__ dw, long long wcount,
                                 long long slices) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= wcount) return;
  float s = 0.f;
  for (long long t = 0; t < slices; ++t) s += partial[t * wcount + i];
  dw[i] = s;
}

template <typename T, int KMAX, int CO_R>
cudaError_t launch_partial(const Plan& p, const void* x, const void* g,
                           float* partial, int n, int cin, int cout, int h,
                           int wd, int k, cudaStream_t stream) {
  auto kernel = dw_partial_kernel<T, KMAX, CO_R>;
  if (p.smem > kDefaultSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((unsigned)(n * p.bands), p.co_chunks, p.ci_chunks);
  const int threads = (p.units + 31) / 32 * 32;
  kernel<<<grid, threads, p.smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), partial, cin, cout,
      h, wd, k, p.ci_chunk, p.co_chunk, p.co_groups, p.units, p.rows,
      p.bands);
  return cudaGetLastError();
}

template <typename T, int KMAX>
cudaError_t launch_k(const Plan& p, const void* x, const void* g,
                     float* partial, int n, int cin, int cout, int h, int wd,
                     int k, cudaStream_t stream) {
  if (p.co_r == 4)
    return launch_partial<T, KMAX, 4>(p, x, g, partial, n, cin, cout, h, wd,
                                      k, stream);
  return launch_partial<T, KMAX, 8>(p, x, g, partial, n, cin, cout, h, wd, k,
                                    stream);
}

template <typename T>
cudaError_t launch(const Plan& p, const void* x, const void* g, float* partial,
                   int n, int cin, int cout, int h, int wd, int k,
                   cudaStream_t stream) {
  if (k <= 3)
    return launch_k<T, 3>(p, x, g, partial, n, cin, cout, h, wd, k, stream);
  if (k <= 7)
    return launch_k<T, 7>(p, x, g, partial, n, cin, cout, h, wd, k, stream);
  return launch_k<T, kMaxK>(p, x, g, partial, n, cin, cout, h, wd, k, stream);
}

bool valid(int n, int cin, int cout, int h, int wd, int k) {
  return n > 0 && cin > 0 && cout > 0 && h > 0 && wd > 0 && k > 1 &&
         k % 2 == 1 && k <= kMaxK && k / 2 < h && k / 2 < wd &&
         (long long)n * ((h + kTileH - 1) / kTileH) <= INT_MAX;
}

}  // namespace

// Floats of f32 scratch that vct_starved_dw needs for these shapes (the
// slices of pass 1), or -1 when the kernel does not take them.
extern "C" long long vct_dw_scratch_floats(int n, int cin, int cout, int h,
                                           int wd, int k) {
  if (!valid(n, cin, cout, h, wd, k)) return -1;
  const Plan p = make_plan(n, cin, cout, h, k);
  if (p.smem > kMaxSmem) return -1;
  return p.slices * cout * cin * k * k;
}

// x: contiguous (n, cin, h, wd); g: contiguous (n, cout, h, wd) of the same
// type; dw: contiguous f32 (cout, cin, k, k); scratch: f32, at least
// vct_dw_scratch_floats(...) floats. dtype: vct::kFloat32 or
// vct::kBFloat16. Requires odd 1 < k <= 15 with k / 2 < min(h, wd). Returns
// the cudaError_t of the launches (0 = success).
extern "C" int vct_starved_dw(const void* x, const void* g, void* dw,
                              void* scratch, int n, int cin, int cout, int h,
                              int wd, int k, int dtype, void* stream) {
  if (!valid(n, cin, cout, h, wd, k)) return (int)cudaErrorInvalidValue;
  const Plan p = make_plan(n, cin, cout, h, k);
  if (p.smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* partial = static_cast<float*>(scratch);
  cudaError_t e;
  if (dtype == vct::kFloat32)
    e = launch<float>(p, x, g, partial, n, cin, cout, h, wd, k, s);
  else if (dtype == vct::kBFloat16)
    e = launch<__nv_bfloat16>(p, x, g, partial, n, cin, cout, h, wd, k, s);
  else
    return (int)cudaErrorInvalidValue;
  if (e != cudaSuccess) return (int)e;
  const long long wcount = (long long)cout * cin * k * k;
  const int threads = 256;
  dw_reduce_kernel<<<(unsigned)((wcount + threads - 1) / threads), threads, 0,
                     s>>>(partial, static_cast<float*>(dw), wcount, p.slices);
  return (int)cudaGetLastError();
}
