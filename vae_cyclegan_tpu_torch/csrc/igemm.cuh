// Building blocks of K6's kernel (lowcin_conv.cu) and the dot probe
// (dot_probe.cu); starved_conv.cu (K3), starved_dw.cu (K4) and nhwc_conv.cuh
// (K5, K7) take parts of it (the mma, the tiles, the conversions).
//
// K6's kernel is an implicit GEMM whose operands both sit in shared
// memory for the whole K loop: the weights, staged once per block, and the
// slab of input under the block's output tile, staged once per tile. The K
// loop then reads mma fragments straight from them, with no barrier and no
// device-memory load inside it:
//
//   bf16: warp-level mma.sync.aligned.m16n8k16 (bf16 in, f32 accumulate); the
//         block's four warps split its BM x BN output tile
//   f32:  f32 FMAs (TF32 would not keep f32's precision); each thread owns
//         BM * BN / 128 elements of the tile
//
// Both sum each element's products in one fixed order (K ascending), so a
// launch repeats bit for bit.
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

// A GEMM operand gathered from an input slab in shared memory: element
// (row, k) at p[row * stride + koff[k / 2] + (k & 1) * next], koff a table of
// the slab offset of each contraction pair (k, k + 1), k even.
template <typename T>
struct Slab {
  const T* p;
  const int* koff;
  int stride, next;
  __device__ __forceinline__ const T* at(int row, int k) const {
    return p + row * stride + koff[k >> 1];
  }
  __device__ __forceinline__ uint32_t pair(int row, int k) const {
    const T* q = at(row, k);
    return bits(q[0]) | (bits(q[next]) << 16);
  }
  __device__ __forceinline__ float value(int row, int k) const {
    return to_f(at(row, k)[(k & 1) * next]);
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

// Copy `rows` rows of `width` elements into shared memory: dst[r * width + e]
// = row_src(r)[e] for e < row_len(r), zeros after (row_len may exceed width:
// it is clipped). Every load of a batch is issued before its stores, so a
// thread waits on memory once per batch, not once per element. `vec`: every
// row_src(r) is 16-byte aligned and width a multiple of 16 bytes, so 16-byte
// loads and stores are used. All threads of the block call it.
template <typename T, class Src, class Len>
__device__ __forceinline__ void copy_rows(T* dst, int rows, int width,
                                          bool vec, Src row_src, Len row_len) {
  if (vec) {
    constexpr int V = 16 / sizeof(T), kBatch = 8;
    const int wv = width / V, total = rows * wv;
    for (int i0 = 0; i0 < total; i0 += kThreads * kBatch) {
      uint4 v[kBatch];
      bool whole[kBatch];  // else the vector straddles the row's end
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const int i = i0 + b * kThreads + threadIdx.x;
        v[b] = make_uint4(0u, 0u, 0u, 0u);
        whole[b] = true;
        if (i < total) {
          const int r = i / wv, e = (i - r * wv) * V;
          const int len = min(row_len(r), width);
          const T* s = row_src(r) + e;
          if (e + V <= len) {
            v[b] = *reinterpret_cast<const uint4*>(s);
          } else if (e < len) {  // rare: element by element, here and now
            whole[b] = false;
            for (int j = 0; j < V; ++j)
              dst[(long long)i * V + j] = e + j < len ? s[j] : from_f<T>(0.f);
          }
        }
      }
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const int i = i0 + b * kThreads + threadIdx.x;
        if (i < total && whole[b]) reinterpret_cast<uint4*>(dst)[i] = v[b];
      }
    }
  } else {
    constexpr int kBatch = 16;
    const int total = rows * width;
    const T zero = from_f<T>(0.f);
    for (int i0 = 0; i0 < total; i0 += kThreads * kBatch) {
      T v[kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const int i = i0 + b * kThreads + threadIdx.x;
        v[b] = zero;
        if (i < total) {
          const int r = i / width, e = i - r * width;
          if (e < row_len(r)) v[b] = row_src(r)[e];
        }
      }
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const int i = i0 + b * kThreads + threadIdx.x;
        if (i < total) dst[i] = v[b];
      }
    }
  }
}

// bytes rounded up to 16
__host__ __device__ constexpr size_t align16(size_t b) { return (b + 15) / 16 * 16; }

// Tiles each block of a launch walks: about eight blocks for each of an
// H100's 132 SMs (so one block's staged weights serve several tiles), at
// least one tile each.
inline int tiles_per_block(long long tiles) {
  const long long target = 132LL * 8;
  return (int)(tiles > target ? (tiles + target - 1) / target : 1);
}

// Launch `kernel` with `smem` bytes of dynamic shared memory, raising the
// kernel's limit first where it needs more than the default 48 KB.
template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, dim3 grid, size_t smem, cudaStream_t stream,
                   Args... args) {
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem > kDefaultSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<grid, kThreads, smem, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace igemm
}  // namespace vct
