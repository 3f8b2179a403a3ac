// InstanceNorm + activation split into its two passes, for planes whose rows
// lie on several ranks (spatial parallelism): a statistics kernel and an apply
// kernel, with the all-reduce of the statistics over the spatial group between
// them (in Python).
//
// Replaces vae_cyclegan_tpu/ops/instance_norm.py::_pallas_in_act_tiled's two
// pallas_calls (:190, :198) one for one: vct_in_stats is _stats_kernel (:138;
// per (n, c) plane, in f32, the sum s and the sum of squares ss of h, h =
// act(x) for act_norm, else x) and vct_in_apply is _apply_kernel (:157; from
// x, the reduced (s, ss) and the GLOBAL element count of the plane: mu = s /
// count, var = max(ss / count - mu^2, 0), y = (h - mu) * rsqrt(var + eps), the
// activation after the norm for norm_act, one rounding to x's type at the
// end). In one process K2 (in_act_tiled.cu) does both passes with the plane
// held on chip; here the plane's rows on this rank are only a part of it, so
// the sums must leave the card before the apply can run. The apply also
// writes each plane's (mu, rsqrt(var + eps)), which the backward keeps.
//
// What bounds both: device-memory bytes (stats reads x once and writes 8 bytes
// a plane; apply reads x once, the sums once, and writes y and 8 bytes of
// moments a plane once), a handful of flops an element. At the path's small
// planes (a rank's 8 x 16 rows) a call moves a few MB and the latency of one
// load and one store sets its time; at the tiled head site (64 x 128 x 256 a
// rank) a call at batch 24 moves 100-200 MB, beyond the 50 MB L2.
//
// Design: both passes take K1's and K2's plan (in_plane.cuh's plan_plane) by
// the bytes of a rank's plane, and its pieces (load_held, held_sums,
// store_held, CtaSums, stream_sums, stream_store, launch_grid). Each thread
// issues all its 16-byte loads (up to eight; four a trip when looping)
// before it uses any, holding them as loaded (bf16 packed two to a register),
// so enough bytes are in flight to keep the memory busy.
//
// Stats: (a) up to 2 KB, the fewest lanes that hold the plane, summed by a
// butterfly over them; (b) up to 32 KB, a CTA a plane holding it; beyond, a
// CTA a plane looping over it, in place of the core's clusters
// (stats_stream_kernel says why). Every sum is taken in a fixed order with no
// atomics (a thread's loads in order, the lanes' butterfly, the warps in
// order) and one thread writes a plane's (s, ss), so a second launch repeats
// bit for bit.
//
// Apply: (a) one vector a lane, up to 128 lanes a plane; (b) a CTA a plane;
// (c) C = min(8, bytes / 16 KB) CTAs a plane; (d) eight CTAs a plane looping
// over their shares; a plain launch throughout, nothing is exchanged. Each
// lane group or CTA reads its plane's (s, ss) once and takes the moments
// once, with the roundings of ops/instance_norm.py's plane_moments on the card
// (moments_of), then normalizes and stores its share; no division at all.

#include "in_plane.cuh"

namespace vct {
namespace split {

// (mean, rsqrt(var + eps)) from the plane's sums and the f32 reciprocal of
// its count, rounded as plane_moments rounds them on the card: a product
// each for the mean and E[h^2] (torch divides by a scalar so there), no fused
// multiply-add, rsqrtf (torch.rsqrt's).
__device__ __forceinline__ float2 moments_of(float s, float ss, float inv,
                                             float eps) {
  const float mean = __fmul_rn(s, inv);
  const float var =
      fmaxf(__fsub_rn(__fmul_rn(ss, inv), __fmul_rn(mean, mean)), 0.f);
  return make_float2(mean, rsqrtf(__fadd_rn(var, eps)));
}

// Regime (a) gives a plane L lanes (lanes_for), the fewest that hold it,
// kWarpPlaneThreads / L planes a block: the stats' lanes of a plane sum it
// with shuffles, so L <= 32 there (a warp takes two planes of 8 x 16 bf16,
// where a warp a plane would idle half its lanes); the apply exchanges
// nothing, so it gives each lane one vector and a plane up to 128 lanes.
constexpr int kMinLanes = 4;
constexpr int kStatsLanes = 32;
constexpr int kApplyLanes = 128;

// The lanes a plane of (a) needs at `elems` elements a lane: a power of two
// from kMinLanes to `most`.
inline int lanes_for(long long hw, int elems, int most) {
  int lanes = kMinLanes;
  while (lanes < most && (long long)lanes * elems < hw) lanes *= 2;
  return lanes;
}

// launch(std::integral_constant<int, L>()) for L = lanes.
template <class Launch>
cudaError_t with_lanes(int lanes, Launch&& launch) {
  switch (lanes) {
    case 4: return launch(std::integral_constant<int, 4>());
    case 8: return launch(std::integral_constant<int, 8>());
    case 16: return launch(std::integral_constant<int, 16>());
    case 32: return launch(std::integral_constant<int, 32>());
    case 64: return launch(std::integral_constant<int, 64>());
    case 128: return launch(std::integral_constant<int, 128>());
    default: return cudaErrorInvalidValue;
  }
}

// (a), stats: the L lanes of a plane sum it; the first writes the sums.
template <typename T, int V, int E, int L>
__global__ void __launch_bounds__(kWarpPlaneThreads)
    stats_lanes_kernel(const T* __restrict__ x, float2* __restrict__ out,
                       long long planes, long long hw, int act, int act_norm) {
  const long long plane =
      (long long)blockIdx.x * (kWarpPlaneThreads / L) + threadIdx.x / L;
  const int lane = threadIdx.x % L;
  const bool live = plane < planes;
  Held<true, T, V, E / V> held;
  const int n = live ? load_held(held, x + plane * hw, 0, hw, lane, L, act,
                                 act_norm)
                     : 0;
  const float2 s = lanes_sum2<L>(held_sums<true>(held, n, act, act_norm));
  if (live && lane == 0) out[plane] = s;
}

// (b), stats: a CTA a plane holding it; thread 0 writes the sums.
template <typename T, int V, int E>
__global__ void __launch_bounds__(kPlaneThreads)
    stats_cta_kernel(const T* __restrict__ x, float2* __restrict__ out,
                     long long hw, int act, int act_norm) {
  __shared__ float2 warps[2 * kPlaneWarps];
  Held<true, T, V, E / V> held;
  const int n = load_held(held, x + blockIdx.x * hw, 0, hw, threadIdx.x,
                          kPlaneThreads, act, act_norm);
  const float2 s = CtaSums{warps, nullptr, 1}(
      held_sums<true>(held, n, act, act_norm), 0);
  if (threadIdx.x == 0) out[blockIdx.x] = s;
}

// (c) and (d), stats: a CTA a plane looping over it, kStreamLoads loads a
// thread in flight. The core's clusters of CTAs holding a share each timed
// slower here on an H100, at batch 1's 64 head planes too: their barriers
// cost more than the shares save when nothing is written back.
template <typename T, int V>
__global__ void __launch_bounds__(kPlaneThreads)
    stats_stream_kernel(const T* __restrict__ x, float2* __restrict__ out,
                        long long hw, int act, int act_norm) {
  __shared__ float2 warps[2 * kPlaneWarps];
  const float2 s = CtaSums{warps, nullptr, 1}(
      stream_sums<true, V>(x + blockIdx.x * hw, 0, hw, act, act_norm), 0);
  if (threadIdx.x == 0) out[blockIdx.x] = s;
}

// The plane's moments from its sums (s, ss) at stats[2 plane], and where the
// apply writes them: mean at moments[plane], rsqrt at moments[planes + plane].
struct Moments {
  const float* stats;
  float* moments;
  long long planes;
  float inv_count;
  float eps;

  __device__ __forceinline__ float2 read(long long plane) const {
    return moments_of(__ldg(stats + 2 * plane), __ldg(stats + 2 * plane + 1),
                      inv_count, eps);
  }
  __device__ __forceinline__ void write(long long plane, float2 m) const {
    moments[plane] = m.x;
    moments[planes + plane] = m.y;
  }
};

// (a), apply: the L lanes of a plane normalize it, E elements each.
template <typename T, int V, int E, int L>
__global__ void __launch_bounds__(kWarpPlaneThreads)
    apply_lanes_kernel(const T* __restrict__ x, T* __restrict__ y, Moments m,
                       long long hw, int act, int act_norm) {
  const long long plane =
      (long long)blockIdx.x * (kWarpPlaneThreads / L) + threadIdx.x / L;
  if (plane >= m.planes) return;  // no barrier or shuffle follows
  const int lane = threadIdx.x % L;
  const long long base = plane * hw;
  Held<true, T, V, E / V> held;
  const int n = load_held(held, x + base, 0, hw, lane, L, act, act_norm);
  const float2 st = m.read(plane);
  store_held(held, n, y + base, 0, lane, L, st, act, act_norm);
  if (lane == 0) m.write(plane, st);
}

// (b) and (c), apply: `cluster` consecutive CTAs per plane (a plain launch:
// nothing is exchanged), CTA r normalizing [r * share, (r + 1) * share).
template <typename T, int V, int E>
__global__ void __launch_bounds__(kPlaneThreads)
    apply_cta_kernel(const T* __restrict__ x, T* __restrict__ y, Moments m,
                     long long hw, long long share, int cluster, int act,
                     int act_norm) {
  const long long plane = blockIdx.x / cluster;
  const int rank = blockIdx.x % cluster;
  const long long base = plane * hw;
  const long long begin = rank * share;
  const long long end = begin + share < hw ? begin + share : hw;
  Held<true, T, V, E / V> held;
  const int n = load_held(held, x + base, begin, end, threadIdx.x,
                          kPlaneThreads, act, act_norm);
  const float2 st = m.read(plane);
  store_held(held, n, y + base, begin, threadIdx.x, kPlaneThreads, st, act,
             act_norm);
  if (rank == 0 && threadIdx.x == 0) m.write(plane, st);
}

// (d), apply: kMaxCluster CTAs per plane, each looping over its share.
template <typename T, int V>
__global__ void __launch_bounds__(kPlaneThreads)
    apply_stream_kernel(const T* __restrict__ x, T* __restrict__ y, Moments m,
                        long long hw, long long share, int act,
                        int act_norm) {
  const long long plane = blockIdx.x / kMaxCluster;
  const int rank = blockIdx.x % kMaxCluster;
  const long long base = plane * hw;
  const long long begin = rank * share;
  const long long end = begin + share < hw ? begin + share : hw;
  const float2 st = m.read(plane);
  stream_store<V>(x + base, y + base, begin, end, st, act, act_norm);
  if (rank == 0 && threadIdx.x == 0) m.write(plane, st);
}

template <typename T, int V>
cudaError_t stats_vec(const PlanePlan& p, const T* x, float2* out,
                      long long planes, long long hw, int act, int act_norm,
                      cudaStream_t stream) {
  constexpr int kLo = 16 / (int)sizeof(T);
  if (p.regime == kRegimeCluster || p.regime == kRegimeStream)
    return launch_grid(stats_stream_kernel<T, V>, planes, kPlaneThreads, 1,
                       stream, x, out, hw, act, act_norm);
  return with_elems<kLo>(p, [&](auto e) -> cudaError_t {
    constexpr int E = decltype(e)::value;
    if (p.regime == kRegimeBlock)
      return launch_grid(stats_cta_kernel<T, V, E>, planes, kPlaneThreads, 1,
                         stream, x, out, hw, act, act_norm);
    const int lanes = lanes_for(hw, E, kStatsLanes);
    return with_lanes(lanes, [&](auto l) -> cudaError_t {
      constexpr int L = decltype(l)::value;
      // more than one vector a lane only where a plane takes a whole warp
      if constexpr (L > kStatsLanes || E > 4 * kLo || (E > kLo && L < 32))
        return cudaErrorInvalidValue;
      else
        return launch_grid(stats_lanes_kernel<T, V, E, L>,
                           ceil_div(planes, kWarpPlaneThreads / L),
                           kWarpPlaneThreads, 1, stream, x, out, planes, hw,
                           act, act_norm);
    });
  });
}

template <typename T, int V>
cudaError_t apply_vec(const PlanePlan& p, const T* x, T* y, const Moments& m,
                      long long hw, int act, int act_norm,
                      cudaStream_t stream) {
  constexpr int kLo = 16 / (int)sizeof(T);
  if (p.regime == kRegimeWarp)
    return with_lanes(lanes_for(hw, kLo, kApplyLanes), [&](auto l) {
      constexpr int L = decltype(l)::value;
      return launch_grid(apply_lanes_kernel<T, V, kLo, L>,
                         ceil_div(m.planes, kWarpPlaneThreads / L),
                         kWarpPlaneThreads, 1, stream, x, y, m, hw, act,
                         act_norm);
    });
  if (p.regime == kRegimeStream)
    return launch_grid(apply_stream_kernel<T, V>, m.planes * kMaxCluster,
                       kPlaneThreads, 1, stream, x, y, m, hw, p.share, act,
                       act_norm);
  return with_elems<kLo>(p, [&](auto e) {
    return launch_grid(apply_cta_kernel<T, V, decltype(e)::value>,
                       m.planes * p.cluster, kPlaneThreads, 1, stream, x, y,
                       m, hw, p.share, p.cluster, act, act_norm);
  });
}

template <typename T>
cudaError_t stats_typed(const void* x, void* out, long long planes,
                        long long hw, int act, int act_norm,
                        cudaStream_t stream) {
  const bool vec = vector_ok(x, x, hw, (int)sizeof(T));
  const PlanePlan p = plan_plane(hw, (int)sizeof(T), vec);
  const T* xt = static_cast<const T*>(x);
  float2* o = static_cast<float2*>(out);
  if (vec)
    return stats_vec<T, 16 / (int)sizeof(T)>(p, xt, o, planes, hw, act,
                                             act_norm, stream);
  return stats_vec<T, 1>(p, xt, o, planes, hw, act, act_norm, stream);
}

template <typename T>
cudaError_t apply_typed(const void* x, void* y, const Moments& m,
                        long long hw, int act, int act_norm,
                        cudaStream_t stream) {
  const bool vec = vector_ok(x, y, hw, (int)sizeof(T));
  const PlanePlan p = plan_plane(hw, (int)sizeof(T), vec);
  if (m.planes * kMaxCluster > INT_MAX) return cudaErrorInvalidValue;
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  if (vec)
    return apply_vec<T, 16 / (int)sizeof(T)>(p, xt, yt, m, hw, act, act_norm,
                                             stream);
  return apply_vec<T, 1>(p, xt, yt, m, hw, act, act_norm, stream);
}

inline bool valid(long long planes, long long hw, int act) {
  return planes > 0 && planes <= INT_MAX && hw > 0 && act >= 0 &&
         act <= kIdentity;
}

}  // namespace split
}  // namespace vct

// x: a contiguous (planes, hw) view of an NCHW tensor (planes = N*C, hw =
// H*W, this rank's rows); stats: (planes, 2) float32, 8-byte aligned,
// written. dtype vct::kFloat32 or vct::kBFloat16; act vct::kRelu..
// vct::kIdentity; act_norm 1: the sums of act(x), 0: of x. Returns the
// cudaError_t of the launch.
extern "C" int vct_in_stats(const void* x, void* stats, long long planes,
                            long long hw, int dtype, int act, int act_norm,
                            void* stream) {
  using namespace vct;
  if (!split::valid(planes, hw, act)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return (int)split::stats_typed<float>(x, stats, planes, hw, act, act_norm,
                                          s);
  if (dtype == kBFloat16)
    return (int)split::stats_typed<__nv_bfloat16>(x, stats, planes, hw, act,
                                                  act_norm, s);
  return (int)cudaErrorInvalidValue;
}

// x, y: contiguous (planes, hw) views; stats: (planes, 2) float32, the sums
// over the whole plane (every rank's rows); inv_count: 1 / the whole plane's
// element count, rounded to f32; moments: (2, planes) float32, written: each
// plane's mean, then its rsqrt(var + eps). act_norm 1: y = norm(act(x)), 0:
// y = act(norm(x)).
extern "C" int vct_in_apply(const void* x, const void* stats, void* y,
                            void* moments, long long planes, long long hw,
                            float inv_count, int dtype, int act, int act_norm,
                            float eps, void* stream) {
  using namespace vct;
  if (!split::valid(planes, hw, act) || !(inv_count > 0.f) ||
      !(inv_count <= 1.f))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const split::Moments m{static_cast<const float*>(stats),
                         static_cast<float*>(moments), planes, inv_count,
                         eps};
  if (dtype == kFloat32)
    return (int)split::apply_typed<float>(x, y, m, hw, act, act_norm, s);
  if (dtype == kBFloat16)
    return (int)split::apply_typed<__nv_bfloat16>(x, y, m, hw, act, act_norm,
                                                  s);
  return (int)cudaErrorInvalidValue;
}
