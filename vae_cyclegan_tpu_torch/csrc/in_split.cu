// InstanceNorm + activation split into its two passes, for planes whose rows
// lie on several ranks (spatial parallelism): a statistics kernel and an apply
// kernel, with the all-reduce of the statistics over the spatial group between
// them (in Python).
//
// Replaces vae_cyclegan_tpu/ops/instance_norm.py::_pallas_in_act_tiled's two
// pallas_calls one for one: vct_in_stats is _stats_kernel (per (n, c) plane,
// in f32, the sum s and the sum of squares ss of h, h = act(x) for act_norm,
// else x) and vct_in_apply is _apply_kernel (from x, the reduced (s, ss) and
// the GLOBAL element count of the plane: mu = s / count, var = max(ss / count
// - mu^2, 0), y = (h - mu) * rsqrt(var + eps), the activation after the norm
// for norm_act, one rounding to x's type at the end). In one process K2
// (in_act_tiled.cu) does both passes with the plane held on chip; here the
// plane's rows on this rank are only a part of it, so the sums must leave the
// card before the apply can run.
//
// What bounds both: device-memory bytes (stats reads x once and writes 8 bytes
// a plane; apply reads x once and writes y once), a handful of flops an
// element.
//
// Design (simple first): stats gives a plane G threads, G = 32 (one warp, no
// shared memory) for planes of at most 2 KB and G = 256 (one CTA, the warps'
// partials summed in warp order through shared memory) beyond, eight or one
// planes a 256-thread block; each thread walks its elements in 16-byte
// vectors where x is 16-byte aligned and hw a multiple of the vector (in_
// plane.cuh's loads and activation), else one element at a time. Every sum is
// taken in a fixed order, so a launch repeats bit for bit. Apply is a
// grid-stride elementwise pass over the vectors of x; a vector never crosses a
// plane (hw is a multiple of it), so each reads its plane's (s, ss) once.

#include "in_plane.cuh"

namespace vct {
namespace split {

constexpr int kThreads = 256;
constexpr long long kWarpPlaneBytes = 2 * 1024;
constexpr long long kMaxApplyBlocks = 8192;

// G threads a plane, kThreads / G planes a block; out[2 * plane + {0, 1}] =
// (s, ss).
template <typename T, int V, int G>
__global__ void __launch_bounds__(kThreads)
    stats_kernel(const T* __restrict__ x, float* __restrict__ out,
                 long long planes, long long hw, int act, int act_norm) {
  constexpr int kPer = kThreads / G;
  const int lane = threadIdx.x % G;
  const long long plane = (long long)blockIdx.x * kPer + threadIdx.x / G;
  float2 acc = make_float2(0.f, 0.f);
  if (plane < planes) {
    const T* p = x + plane * hw;
    for (long long i = (long long)lane * V; i < hw; i += (long long)G * V) {
      float v[V];
      unpack_h<V, T>(load_raw<V>(p + i), v, act, act_norm);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        acc.x += v[j];
        acc.y += v[j] * v[j];
      }
    }
  }
  acc = warp_sum2(acc);
  if constexpr (G == 32) {
    if (lane == 0 && plane < planes) {
      out[2 * plane] = acc.x;
      out[2 * plane + 1] = acc.y;
    }
  } else {
    __shared__ float2 part[kThreads / 32];
    if ((threadIdx.x & 31) == 0) part[threadIdx.x / 32] = acc;
    __syncthreads();
    if (threadIdx.x == 0 && plane < planes) {
      float2 s = part[0];
#pragma unroll
      for (int w = 1; w < kThreads / 32; ++w) {
        s.x += part[w].x;
        s.y += part[w].y;
      }
      out[2 * plane] = s.x;
      out[2 * plane + 1] = s.y;
    }
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    apply_kernel(const T* __restrict__ x, const float* __restrict__ stats,
                 T* __restrict__ y, long long planes, long long hw,
                 float count, int act, int act_norm, float eps) {
  const long long vecs = planes * hw / V;
  const long long step = (long long)gridDim.x * kThreads;
  for (long long q = (long long)blockIdx.x * kThreads + threadIdx.x; q < vecs;
       q += step) {
    const long long i = q * V;
    const long long plane = i / hw;
    const float mean = __ldg(stats + 2 * plane) / count;
    const float var =
        fmaxf(__ldg(stats + 2 * plane + 1) / count - mean * mean, 0.f);
    const float r = rsqrtf(var + eps);
    float v[V];
    unpack_h<V, T>(load_raw<V>(x + i), v, act, act_norm);
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] = (v[j] - mean) * r;
    if (!act_norm) activate_all<V>(v, act);
    store_vec<V>(y + i, v);
  }
}

template <typename T, int V>
cudaError_t stats_typed(const T* x, float* out, long long planes,
                        long long hw, int act, int act_norm,
                        cudaStream_t stream) {
  if (hw * (long long)sizeof(T) <= kWarpPlaneBytes) {
    const long long blocks = ceil_div(planes, kThreads / 32);
    if (blocks > INT_MAX) return cudaErrorInvalidValue;
    stats_kernel<T, V, 32><<<(unsigned)blocks, kThreads, 0, stream>>>(
        x, out, planes, hw, act, act_norm);
  } else {
    if (planes > INT_MAX) return cudaErrorInvalidValue;
    stats_kernel<T, V, kThreads><<<(unsigned)planes, kThreads, 0, stream>>>(
        x, out, planes, hw, act, act_norm);
  }
  return cudaGetLastError();
}

template <typename T, int V>
cudaError_t apply_typed(const T* x, const float* stats, T* y,
                        long long planes, long long hw, float count, int act,
                        int act_norm, float eps, cudaStream_t stream) {
  long long blocks = ceil_div(planes * hw / V, kThreads);
  if (blocks > kMaxApplyBlocks) blocks = kMaxApplyBlocks;
  apply_kernel<T, V><<<(unsigned)blocks, kThreads, 0, stream>>>(
      x, stats, y, planes, hw, count, act, act_norm, eps);
  return cudaGetLastError();
}

inline bool aligned(const void* p) {
  return reinterpret_cast<std::uintptr_t>(p) % 16 == 0;
}

template <typename T>
int stats_entry(const void* x, void* out, long long planes, long long hw,
                int act, int act_norm, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  float* o = static_cast<float*>(out);
  constexpr int kVec = 16 / (int)sizeof(T);
  if (aligned(x) && hw % kVec == 0)
    return (int)stats_typed<T, kVec>(xt, o, planes, hw, act, act_norm, s);
  return (int)stats_typed<T, 1>(xt, o, planes, hw, act, act_norm, s);
}

template <typename T>
int apply_entry(const void* x, const void* stats, void* y, long long planes,
                long long hw, float count, int act, int act_norm, float eps,
                cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  const float* st = static_cast<const float*>(stats);
  T* yt = static_cast<T*>(y);
  constexpr int kVec = 16 / (int)sizeof(T);
  if (aligned(x) && aligned(y) && hw % kVec == 0)
    return (int)apply_typed<T, kVec>(xt, st, yt, planes, hw, count, act,
                                     act_norm, eps, s);
  return (int)apply_typed<T, 1>(xt, st, yt, planes, hw, count, act, act_norm,
                                eps, s);
}

inline bool valid(long long planes, long long hw, int act) {
  return planes > 0 && hw > 0 && act >= 0 && act <= kIdentity;
}

}  // namespace split
}  // namespace vct

// x: a contiguous (planes, hw) view of an NCHW tensor (planes = N*C, hw =
// H*W, this rank's rows); stats: (planes, 2) float32, written. dtype
// vct::kFloat32 or vct::kBFloat16; act vct::kRelu..vct::kIdentity; act_norm 1:
// the sums of act(x), 0: of x. Returns the cudaError_t of the launch.
extern "C" int vct_in_stats(const void* x, void* stats, long long planes,
                            long long hw, int dtype, int act, int act_norm,
                            void* stream) {
  using namespace vct;
  if (!split::valid(planes, hw, act)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return split::stats_entry<float>(x, stats, planes, hw, act, act_norm, s);
  if (dtype == kBFloat16)
    return split::stats_entry<__nv_bfloat16>(x, stats, planes, hw, act,
                                             act_norm, s);
  return (int)cudaErrorInvalidValue;
}

// x, y: contiguous (planes, hw) views; stats: (planes, 2) float32, the sums
// over the whole plane (every rank's rows); count: the whole plane's element
// count. act_norm 1: y = norm(act(x)), 0: y = act(norm(x)).
extern "C" int vct_in_apply(const void* x, const void* stats, void* y,
                            long long planes, long long hw, float count,
                            int dtype, int act, int act_norm, float eps,
                            void* stream) {
  using namespace vct;
  if (!split::valid(planes, hw, act) || !(count > 0.f))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return split::apply_entry<float>(x, stats, y, planes, hw, count, act,
                                     act_norm, eps, s);
  if (dtype == kBFloat16)
    return split::apply_entry<__nv_bfloat16>(x, stats, y, planes, hw, count,
                                             act, act_norm, eps, s);
  return (int)cudaErrorInvalidValue;
}
