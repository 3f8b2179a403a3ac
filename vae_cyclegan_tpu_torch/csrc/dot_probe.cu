// The dw dot probe: out (mk, nk) f32 = sum over `steps` passes of p . g^T,
// p (mk, kk) and g (nk, kk) of one type, each pass's whole K = kk contraction
// summed afresh in f32 and then added to the accumulator, in pass order.
//
// Replaces experiments/dw_dot_probe.py::make (kernel body kern). The TPU
// kernel walks a sequential grid of `steps` steps over the same VMEM-resident
// operands, adding each step's dot to an f32 scratch; it times the MXU on the
// weight-gradient dot shapes of the k7 and k3 starved convs. Hopper's blocks
// run in no order, so the steps become a loop inside each block: a block of
// eight warps owns a 16 x 32 (or 32 x 16) output tile, each warp contracts
// its eighth of K with mma.sync (bf16) or FMAs (f32), reading its fragments
// straight from device memory (the operands, 0.2-4 MB, stay in L2), and per
// step the eight partial tiles are summed in warp order in shared memory and
// added to the tile's accumulator. Every step is computed afresh; the kernel
// never folds them into steps x (p . g^T).
//
// What bounds it: the probe shapes do 34.7-65.5 GFLOP on 1-11 MB, so the
// tensor cores bound it (0.035-0.066 ms at 989 TFLOP/s). Its outputs are few
// (10,752-18,432), so it runs 21-36 blocks, one per SM, each waiting on L2
// for its fragments; spreading a step over more SMs needs a cross-block sum
// per step, a later design.

#include "igemm.cuh"

namespace {

using vct::igemm::bits;
using vct::igemm::mma_bf16;
using vct::igemm::to_f;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kUnroll = 4;  // k16 steps whose fragments are loaded together

// two adjacent bf16 of a row of length kk from column col (even); zeros
// past the row's end. `aligned`: 4-byte loads are allowed (kk even and both
// operands 4-byte aligned).
__device__ __forceinline__ uint32_t frag_pair(const __nv_bfloat16* rowp,
                                              int col, int kk, bool aligned) {
  if (aligned && col + 1 < kk)
    return *reinterpret_cast<const uint32_t*>(rowp + col);
  const uint32_t lo = col < kk ? bits(rowp[col]) : 0u;
  const uint32_t hi = col + 1 < kk ? bits(rowp[col + 1]) : 0u;
  return lo | (hi << 16);
}

template <typename T, int TM, int TN>
__global__ void __launch_bounds__(kThreads)
    dot_probe_kernel(const T* __restrict__ p, const T* __restrict__ g,
                     float* __restrict__ out, int mk, int nk, int kk,
                     int steps, int tiles_n, bool aligned) {
  constexpr bool kMma = std::is_same<T, __nv_bfloat16>::value;
  constexpr int MI = TM / 16, NI = TN / 8;
  constexpr int PART = kMma ? MI * NI * 4 : TM * TN / 32;
  constexpr int OWN = TM * TN / kThreads;
  static_assert(TM % 16 == 0 && TN % 8 == 0 && TM * TN % kThreads == 0, "tile");
  __shared__ float red[kWarps][TM * TN];  // the warps' partial tiles

  const int m0 = (blockIdx.x / tiles_n) * TM;
  const int n0 = (blockIdx.x % tiles_n) * TN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  // the warp's slice of K, a multiple of 16 long (the last one ends at kk)
  const int per = (kk + kWarps * 16 - 1) / (kWarps * 16) * 16;
  const int kb = warp * per, ke = min(kk, kb + per);

  float acc[OWN];
#pragma unroll
  for (int o = 0; o < OWN; ++o) acc[o] = 0.f;

  for (int s = 0; s < steps; ++s) {
    float part[PART];
#pragma unroll
    for (int i = 0; i < PART; ++i) part[i] = 0.f;
    if constexpr (kMma) {
      const T* arow[MI][2];
      const T* brow[NI];
      bool aok[MI][2], bok[NI];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int m = m0 + mi * 16 + gid + 8 * hh;
          aok[mi][hh] = m < mk;
          arow[mi][hh] = p + (long long)min(m, mk - 1) * kk;
        }
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const int n = n0 + ni * 8 + gid;
        bok[ni] = n < nk;
        brow[ni] = g + (long long)min(n, nk - 1) * kk;
      }
      for (int k0 = kb; k0 < ke; k0 += 16 * kUnroll) {
        uint32_t af[kUnroll][MI][4], bf[kUnroll][NI][2];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int c = k0 + 16 * u + tig * 2;
          const bool live = k0 + 16 * u < ke;
#pragma unroll
          for (int mi = 0; mi < MI; ++mi) {
            const bool r0 = live && aok[mi][0], r1 = live && aok[mi][1];
            af[u][mi][0] = r0 ? frag_pair(arow[mi][0], c, kk, aligned) : 0u;
            af[u][mi][1] = r1 ? frag_pair(arow[mi][1], c, kk, aligned) : 0u;
            af[u][mi][2] = r0 ? frag_pair(arow[mi][0], c + 8, kk, aligned) : 0u;
            af[u][mi][3] = r1 ? frag_pair(arow[mi][1], c + 8, kk, aligned) : 0u;
          }
#pragma unroll
          for (int ni = 0; ni < NI; ++ni) {
            const bool r = live && bok[ni];
            bf[u][ni][0] = r ? frag_pair(brow[ni], c, kk, aligned) : 0u;
            bf[u][ni][1] = r ? frag_pair(brow[ni], c + 8, kk, aligned) : 0u;
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
#pragma unroll
          for (int mi = 0; mi < MI; ++mi)
#pragma unroll
            for (int ni = 0; ni < NI; ++ni)
              mma_bf16(part + (mi * NI + ni) * 4, af[u][mi], bf[u][ni]);
      }
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int m = mi * 16 + gid + (i >= 2 ? 8 : 0);
            const int n = ni * 8 + tig * 2 + (i & 1);
            red[warp][m * TN + n] = part[(mi * NI + ni) * 4 + i];
          }
    } else {
      // lane owns tile elements e = lane + 32 j: (m, n) = (e / TN, e % TN)
      for (int k = kb; k < ke; ++k) {
#pragma unroll
        for (int j = 0; j < PART; ++j) {
          const int e = lane + 32 * j;
          const int m = m0 + e / TN, n = n0 + e % TN;
          if (m < mk && n < nk)
            part[j] = fmaf(to_f(p[(long long)m * kk + k]),
                           to_f(g[(long long)n * kk + k]), part[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < PART; ++j) red[warp][lane + 32 * j] = part[j];
    }
    __syncthreads();
    // this step's product, its slices summed in warp order, then added
#pragma unroll
    for (int o = 0; o < OWN; ++o) {
      const int e = tid + o * kThreads;
      float v = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) v += red[w][e];
      acc[o] += v;
    }
    __syncthreads();  // red is free for the next step
  }

#pragma unroll
  for (int o = 0; o < OWN; ++o) {
    const int e = tid + o * kThreads;
    const int m = m0 + e / TN, n = n0 + e % TN;
    if (m < mk && n < nk) out[(long long)m * nk + n] = acc[o];
  }
}

template <typename T, int TM, int TN>
cudaError_t run(const void* p, const void* g, float* out, int mk, int nk,
                int kk, int steps, cudaStream_t stream) {
  const long long tiles_m = (mk + TM - 1) / TM, tiles_n = (nk + TN - 1) / TN;
  if (tiles_m * tiles_n > 0x7fffffffLL) return cudaErrorInvalidValue;
  const bool aligned = kk % 2 == 0 && reinterpret_cast<uintptr_t>(p) % 4 == 0 &&
                       reinterpret_cast<uintptr_t>(g) % 4 == 0;
  dot_probe_kernel<T, TM, TN><<<(unsigned)(tiles_m * tiles_n), kThreads, 0,
                                stream>>>(static_cast<const T*>(p),
                                          static_cast<const T*>(g), out, mk, nk,
                                          kk, steps, (int)tiles_n, aligned);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* p, const void* g, float* out, int mk, int nk,
                     int kk, int steps, cudaStream_t stream) {
  // the long side of the tile along the longer side of the output
  if (mk <= nk) return run<T, 16, 32>(p, g, out, mk, nk, kk, steps, stream);
  return run<T, 32, 16>(p, g, out, mk, nk, kk, steps, stream);
}

}  // namespace

// p: contiguous (mk, kk); g: contiguous (nk, kk) of the same type; out:
// contiguous float32 (mk, nk). dtype: vct::kFloat32 or vct::kBFloat16.
// Returns the cudaError_t of the launch (0 = success).
extern "C" int vct_dot_probe(const void* p, const void* g, void* out, int mk,
                             int nk, int kk, int steps, int dtype,
                             void* stream) {
  if (mk <= 0 || nk <= 0 || kk <= 0 || steps <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  if (dtype == vct::kFloat32)
    return (int)dispatch<float>(p, g, o, mk, nk, kk, steps, s);
  if (dtype == vct::kBFloat16)
    return (int)dispatch<__nv_bfloat16>(p, g, o, mk, nk, kk, steps, s);
  return (int)cudaErrorInvalidValue;
}
