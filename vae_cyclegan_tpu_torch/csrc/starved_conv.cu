// Stride-1 convolution, odd k, in the three padding modes of the TPU kernel:
// NCHW input, OIHW weight, NCHW output, f32 accumulation, output in the input
// type. No bias (the caller adds it, as the JAX blocks do).
//
//   mode 0, reflect:   reflect-padded SAME (pad k/2), output h x w
//   mode 1, zero_same: zero-padded SAME (pad k/2), output h x w
//   mode 2, zero:      zero-padded FULL correlation (pad k-1), output
//                      (h+k-1) x (w+k-1)
//
// Replaces vae_cyclegan_tpu/ops/starved_conv.py::_conv_call (kernel body
// _conv_kernel) in all three of its modes. On the training path, reflect is
// the forward of the decoder's U4 (k3, 32->64 at 256x256) and tail (k7, 64->3);
// zero_same is the core of the input gradient (dx = reflect-fold of the full
// correlation with the rotated kernel; ops/starved_conv.py applies the fold's
// border strips): U4 dx (64->32 k3), tail dx (3->64 k7) and the encoder
// head's dx (64->3 k7). zero (full) is the fold's oracle, kept for tests.
// Like the TPU kernel, it resolves the halo in the loader, so no padded copy
// of the input is ever written to device memory: in reflect mode row and
// column -1 read 1, row H reads H-2 (no edge repeat), as _row_specs /
// _padded_row do; in the zero modes a halo element outside the image is 0.
//
// What bounds it: U4 at batch 4 is 9.7 GFLOP over 50 MB of bf16 input and
// output (~190 flop/byte), the tail 4.9 GFLOP over 35 MB (~140 flop/byte).
// Both sit far above the f32 CUDA-core ridge (~20 flop/byte), so this first
// version, which runs f32 FMAs on the CUDA cores, is bound by FMA issue and
// shared-memory loads, not by device memory. The tensor cores (wgmma on
// Hopper, an implicit GEMM with K = k*k*cin) are the later, faster design.
//
// Design: a direct convolution. A block of 32x8 threads owns a 32x32 output
// tile for CO_T output channels of one image; each thread owns kRows = 4
// output rows of one column, CO_T * 4 f32 accumulators in registers. Per chunk
// of kChunk input channels the block stages the (32+k-1)^2 input tile with its
// halo, and the chunk's weights, in shared memory as f32. Each (channel, tap)
// step then loads 4 input values and CO_T broadcast weights for 4 * CO_T
// FMAs. Output channels past cout and input channels past cin are zero-filled
// in shared memory and never stored.

#include <climits>

#include "common.cuh"

namespace {

constexpr int kTileW = 32;     // output columns per block (one per thread.x)
constexpr int kThreadsY = 8;   // thread rows per block
constexpr int kRows = 4;       // output rows per thread
constexpr int kTileH = kThreadsY * kRows;
constexpr int kChunk = 4;      // input channels staged per step
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr size_t kMaxSmem = 227 * 1024;

// Padding modes shared with the Python wrapper (ops/starved_conv.py).
constexpr int kReflect = 0;
constexpr int kZeroSame = 1;
constexpr int kZeroFull = 2;

// Reflect without edge repeat (-1 -> 1, n -> n - 2), valid for a halo
// narrower than the image; rows and columns of a tile that lie past the
// image only feed outputs that are never stored, so clamp them.
__device__ __forceinline__ int reflect_index(int i, int n) {
  i = i < 0 ? -i : i;
  i = i >= n ? 2 * n - 2 - i : i;
  return min(max(i, 0), n - 1);
}

template <typename T, int CO_T>
__global__ void __launch_bounds__(kTileW * kThreadsY)
    conv_kernel(const T* __restrict__ x, const T* __restrict__ w,
                T* __restrict__ y, int cin, int cout, int h, int wd,
                int out_h, int out_w, int k, int pad, int mode, int tiles_w) {
  extern __shared__ float smem[];
  const int span_w = kTileW + k - 1;
  const int span_h = kTileH + k - 1;
  const int tile_elems = span_h * span_w;
  const int kk = k * k;
  float* s_in = smem;                         // [kChunk][span_h][span_w]
  float* s_w = smem + kChunk * tile_elems;    // [kChunk][k*k][CO_T]

  const int oh0 = (blockIdx.x / tiles_w) * kTileH;
  const int ow0 = (blockIdx.x % tiles_w) * kTileW;
  const int co0 = blockIdx.y * CO_T;
  const int n = blockIdx.z;
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kTileW + tx;
  const int nthreads = kTileW * kThreadsY;
  const long long plane = (long long)h * wd;
  const long long out_plane = (long long)out_h * out_w;
  const T* xn = x + (long long)n * cin * plane;

  float acc[kRows][CO_T];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int c = 0; c < CO_T; ++c) acc[r][c] = 0.f;

  for (int ci0 = 0; ci0 < cin; ci0 += kChunk) {
    __syncthreads();  // the previous chunk has been consumed
    for (int e = tid; e < kChunk * tile_elems; e += nthreads) {
      const int c = e / tile_elems;
      const int rem = e - c * tile_elems;
      const int i = rem / span_w;
      const int j = rem - i * span_w;
      float v = 0.f;
      if (ci0 + c < cin) {
        int row = oh0 - pad + i;
        int col = ow0 - pad + j;
        bool inside = true;
        if (mode == kReflect) {
          row = reflect_index(row, h);
          col = reflect_index(col, wd);
        } else {
          inside = row >= 0 && row < h && col >= 0 && col < wd;
        }
        if (inside)
          v = vct::load_f(xn, (long long)(ci0 + c) * plane + (long long)row * wd + col);
      }
      s_in[e] = v;
    }
    for (int e = tid; e < kChunk * kk * CO_T; e += nthreads) {
      const int co = e % CO_T;
      const int tap = (e / CO_T) % kk;
      const int c = e / (CO_T * kk);
      float v = 0.f;
      if (ci0 + c < cin && co0 + co < cout)
        v = vct::load_f(w, ((long long)(co0 + co) * cin + ci0 + c) * kk + tap);
      s_w[e] = v;
    }
    __syncthreads();

    for (int c = 0; c < kChunk; ++c) {
      const float* in_c = s_in + c * tile_elems + (ty * kRows) * span_w + tx;
      const float* w_c = s_w + c * kk * CO_T;
      for (int dy = 0; dy < k; ++dy) {
        for (int dx = 0; dx < k; ++dx) {
          float v[kRows];
#pragma unroll
          for (int r = 0; r < kRows; ++r) v[r] = in_c[(r + dy) * span_w + dx];
          const float* wt = w_c + (dy * k + dx) * CO_T;
#pragma unroll
          for (int co = 0; co < CO_T; ++co) {
            const float wv = wt[co];
#pragma unroll
            for (int r = 0; r < kRows; ++r) acc[r][co] = fmaf(v[r], wv, acc[r][co]);
          }
        }
      }
    }
  }

  const int ow = ow0 + tx;
  if (ow >= out_w) return;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int oh = oh0 + ty * kRows + r;
    if (oh >= out_h) continue;
#pragma unroll
    for (int co = 0; co < CO_T; ++co) {
      if (co0 + co < cout)
        vct::store_f(y, ((long long)n * cout + co0 + co) * out_plane +
                            (long long)oh * out_w + ow,
                     acc[r][co]);
    }
  }
}

template <typename T, int CO_T>
cudaError_t launch(const void* x, const void* w, void* y, int n, int cin,
                   int cout, int h, int wd, int k, int mode,
                   cudaStream_t stream) {
  const int pad = mode == kZeroFull ? k - 1 : k / 2;
  const int out_h = h + 2 * pad - (k - 1);
  const int out_w = wd + 2 * pad - (k - 1);
  const size_t smem =
      sizeof(float) * ((size_t)kChunk * (kTileH + k - 1) * (kTileW + k - 1) +
                       (size_t)kChunk * k * k * CO_T);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem > kDefaultSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        conv_kernel<T, CO_T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int tiles_w = (out_w + kTileW - 1) / kTileW;
  const int tiles_h = (out_h + kTileH - 1) / kTileH;
  const dim3 grid(tiles_w * tiles_h, (cout + CO_T - 1) / CO_T, n);
  const dim3 block(kTileW, kThreadsY);
  conv_kernel<T, CO_T><<<grid, block, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(y),
      cin, cout, h, wd, out_h, out_w, k, pad, mode, tiles_w);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, const void* w, void* y, int n, int cin,
                     int cout, int h, int wd, int k, int mode,
                     cudaStream_t stream) {
  if (cout <= 4)
    return launch<T, 4>(x, w, y, n, cin, cout, h, wd, k, mode, stream);
  if (cout <= 8)
    return launch<T, 8>(x, w, y, n, cin, cout, h, wd, k, mode, stream);
  return launch<T, 16>(x, w, y, n, cin, cout, h, wd, k, mode, stream);
}

}  // namespace

// x: contiguous (n, cin, h, wd); w: contiguous (cout, cin, k, k) of the same
// type; y: contiguous (n, cout, out_h, out_w), out = in for modes 0 and 1 and
// in + k - 1 for mode 2. mode: 0 reflect, 1 zero_same, 2 zero (full). dtype:
// vct::kFloat32 or vct::kBFloat16. Requires odd k, and k / 2 < min(h, wd) in
// reflect mode. Returns the cudaError_t of the launch (0 = success).
extern "C" int vct_starved_conv(const void* x, const void* w, void* y, int n,
                                int cin, int cout, int h, int wd, int k,
                                int mode, int dtype, void* stream) {
  if (n <= 0 || n > 65535 || cin <= 0 || cout <= 0 || h <= 0 || wd <= 0 ||
      k <= 0 || k % 2 == 0 || mode < kReflect || mode > kZeroFull ||
      (mode == kReflect && (k / 2 >= h || k / 2 >= wd)) ||
      (long long)((wd + k - 1 + kTileW - 1) / kTileW) *
              ((h + k - 1 + kTileH - 1) / kTileH) > INT_MAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == vct::kFloat32)
    return (int)dispatch<float>(x, w, y, n, cin, cout, h, wd, k, mode, s);
  if (dtype == vct::kBFloat16)
    return (int)dispatch<__nv_bfloat16>(x, w, y, n, cin, cout, h, wd, k, mode,
                                        s);
  return (int)cudaErrorInvalidValue;
}
