// Building blocks of the tensor-core kernels: the mma and the element
// conversions (every kernel on mma.sync), and the warp-level GEMM tile with a
// weight-row operand that K3's kernel (starved_conv.cu) runs, whose operands
// both sit in shared memory for the whole K loop: the weights, staged once
// per block, and the slab of input under the block's output tile, staged
// once per tile. The K loop then reads mma fragments straight from them,
// with no barrier and no device-memory load inside it:
//
//   bf16: warp-level mma.sync.aligned.m16n8k16 (bf16 in, f32 accumulate); the
//         block's four warps split its BM x BN output tile
//   f32:  f32 FMAs (TF32 would not keep f32's precision); each thread owns
//         BM * BN / 128 elements of the tile
//
// Both sum each element's products in one fixed order (K ascending), so a
// launch repeats bit for bit. The dot probe (dot_probe.cu), K4
// (starved_dw.cu) and the NHWC conv core (nhwc_conv.cuh: K5, K6, K7) take
// the mma, the conversions and the shared-memory limits.
#pragma once

#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace vct {
namespace igemm {

constexpr int kThreads = 128;  // 4 warps
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr size_t kMaxSmem = 227 * 1024;

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

// d += a . b for one 16x8x16 tile: bf16 inputs, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float d[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat16 v) {
  return __bfloat16_as_ushort(v);
}

// A GEMM operand held in shared memory as rows of the weight matrix: element
// (row, k) at p[min(row, last) * stride + k]. Rows past `last` (output
// channels past cout) read the last real row; their outputs are never
// stored. stride is even, so a pair (k, k + 1), k even, is one 4-byte word.
template <typename T>
struct Rows {
  const T* p;
  int stride, last;
  __device__ __forceinline__ const T* at(int row, int k) const {
    return p + min(row, last) * stride + k;
  }
  __device__ __forceinline__ uint32_t pair(int row, int k) const {
    return *reinterpret_cast<const uint32_t*>(at(row, k));
  }
  __device__ __forceinline__ float value(int row, int k) const {
    return to_f(*at(row, k));
  }
};

// Fragment rows and columns of m16n8k16 (PTX ISA): lane = 4 * gid + tig;
// A (16x16, row): a0,a1 row gid, a2,a3 row gid + 8, cols 2 tig (+1), and the
// same +8 cols for a4..a7; B (16x8, col): b0,b1 rows 2 tig (+1), b2,b3 +8,
// col gid; C (16x8): c0,c1 row gid, c2,c3 row gid + 8, cols 2 tig (+1).
template <typename T, int BM, int BN, int WARPS_M>
struct Tile {
  static constexpr bool kMma = std::is_same<T, __nv_bfloat16>::value;
  static constexpr int WARPS_N = 4 / WARPS_M;
  static constexpr int WM = BM / WARPS_M;
  static constexpr int WN = BN / WARPS_N;
  static constexpr int MI = WM / 16;
  static constexpr int NI = WN / 8;
  static constexpr int ACC = kMma ? MI * NI * 4 : BM * BN / kThreads;
  static_assert(WARPS_M * WARPS_N == 4 && WM % 16 == 0 && WN % 8 == 0, "tile");
  static_assert(BM * BN % kThreads == 0, "tile");

  // acc += A (BM x kpad) . B (BN x kpad)^T, kpad a multiple of 16, both
  // operands addressed by (tile row, k)
  template <class OpA, class OpB>
  static __device__ __forceinline__ void mac(float* acc, const OpA& a,
                                             const OpB& b, int kpad) {
    const int tid = threadIdx.x;
    if constexpr (kMma) {
      const int warp = tid >> 5, lane = tid & 31;
      const int wm = warp / WARPS_N, wn = warp % WARPS_N;
      const int gid = lane >> 2, tig = lane & 3;
      const int am = wm * WM + gid, bn = wn * WN + gid;
#pragma unroll 2
      for (int k0 = 0; k0 < kpad; k0 += 16) {
        const int k = k0 + tig * 2;
        uint32_t af[MI][4], bf[NI][2];
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) {
          af[mi][0] = a.pair(am + mi * 16, k);
          af[mi][1] = a.pair(am + mi * 16 + 8, k);
          af[mi][2] = a.pair(am + mi * 16, k + 8);
          af[mi][3] = a.pair(am + mi * 16 + 8, k + 8);
        }
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) {
          bf[ni][0] = b.pair(bn + ni * 8, k);
          bf[ni][1] = b.pair(bn + ni * 8, k + 8);
        }
#pragma unroll
        for (int mi = 0; mi < MI; ++mi)
#pragma unroll
          for (int ni = 0; ni < NI; ++ni)
            mma_bf16(acc + (mi * NI + ni) * 4, af[mi], bf[ni]);
      }
    } else {
      for (int k = 0; k < kpad; ++k) {
#pragma unroll
        for (int j = 0; j < ACC; ++j) {
          const int e = tid + j * kThreads;
          acc[j] = fmaf(a.value(e / BN, k), b.value(e % BN, k), acc[j]);
        }
      }
    }
  }

  // f(m, n, v) for each of the thread's accumulators, m and n tile-local
  template <class F>
  static __device__ __forceinline__ void each(const float* acc, F&& f) {
    const int tid = threadIdx.x;
    if constexpr (kMma) {
      const int warp = tid >> 5, lane = tid & 31;
      const int wm = warp / WARPS_N, wn = warp % WARPS_N;
      const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            f(wm * WM + mi * 16 + gid + (i >= 2 ? 8 : 0),
              wn * WN + ni * 8 + tig * 2 + (i & 1), acc[(mi * NI + ni) * 4 + i]);
    } else {
#pragma unroll
      for (int j = 0; j < ACC; ++j) {
        const int e = tid + j * kThreads;
        f(e / BN, e % BN, acc[j]);
      }
    }
  }
};

// bytes rounded up to 16
__host__ __device__ constexpr size_t align16(size_t b) { return (b + 15) / 16 * 16; }

}  // namespace igemm
}  // namespace vct
