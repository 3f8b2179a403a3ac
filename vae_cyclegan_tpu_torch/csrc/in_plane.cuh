// The shared core of the two InstanceNorm + activation kernels (in_act.cu,
// in_act_tiled.cu), whose plan and pieces K2's split pair (in_split.cu) and
// K1's backward (in_act_bwd.cu, which holds x and the cotangent: its plan
// counts the bytes of both) take too: per (n, c) plane of an NCHW tensor, in f32, the statistics
// of h (h = act(x) for act_norm, else x), then y = (h - mean) * rsqrt(var +
// eps), the activation after the norm for norm_act, and one rounding to the
// input type at the end. Var picks the variance: Centered (mean first, then
// the mean of (h - mean)^2; K1) or SinglePass (max(E[h^2] - mean^2, 0), one
// exchange of (s, ss); K2).
//
// What bounds both: device-memory bytes (x read once, y written once, a
// handful of flops per element), and at the path's small planes the latency
// of one load, one reduction and one store. So each plane of the path's
// shapes is read from device memory ONCE, held on chip in registers, reduced
// there and written ONCE, in one launch. Four regimes by bytes per plane (so
// f32 gets half the elements of bf16):
//
//  (a) <= kWarpPlaneBytes (2 KB; bf16 16x16 and 32x32): one warp per plane,
//      eight planes per 256-thread block, a lane holding up to 64 bytes of
//      the plane as h in f32, reduced by warp shuffles alone: no shared
//      memory, no barrier.
//  (b) <= kBlockPlaneBytes (32 KB; bf16 64x64 and 128x128): one 256-thread
//      CTA per plane, a thread holding up to 128 bytes as loaded (bf16 packed
//      two to a register, unpacked again on each pass), warp shuffles, then
//      the warps' partials summed in warp order through shared memory.
//  (c) <= kClusterPlaneBytes (256 KB; bf16 and f32 256x256): a thread block
//      cluster of C = min(8, ceil(bytes / 16 KB)) CTAs per plane, each
//      holding a contiguous share as in (b). Each CTA publishes its partial
//      sums in its shared memory; after a cluster barrier every CTA reads all
//      C partials through distributed shared memory in rank order, so all
//      agree to the bit (K2 one exchange, K1 two: the mean, then the centered
//      sum). A CTA arrives on a last cluster barrier once it has read its
//      peers and waits on it after its stores, so no CTA exits while a peer
//      may still read its shared memory.
//  (d) beyond: a cluster of 8 CTAs per plane, each looping over its share in
//      device memory (K2 reads it twice, K1 three times). No path shape gets
//      here; it is the kernel's own path for big planes, never the plain one.
//
// Loads and stores are 16 bytes a thread (8 bf16 or 4 f32) when x and y are
// 16-byte aligned and hw is a multiple of the vector width, else one element
// a thread; the regimes are the same. Every sum is taken in a fixed order (a
// thread's elements in order, a warp butterfly, the warps in order, the
// cluster's ranks in order) with no atomics, so a launch repeats bit for bit.
//
// The thresholds come from timing variants on an H100 (bf16, the path's
// planes at batch 4 and 24, x cold in L2). Many small CTAs with several
// 16-byte loads in flight per thread kept the card's memory busiest: 256
// threads and 16 KB shares at 256x256 (cluster of 8, four loads a thread)
// beat 512 threads (two loads), 1024 threads (one load) and 32 KB shares
// (cluster of 4); holding the loads packed (half the registers of f32)
// lets more CTAs share an SM; 128x128 in one CTA (eight loads a thread) beat
// a cluster of two. In (a) the f32 values were faster than packed ones. No
// instantiation spills (ptxas -v, chip_smoke's build log).
#pragma once

#include <cooperative_groups.h>

#include <climits>
#include <cstdint>
#include <type_traits>
#include <utility>

#include "common.cuh"

namespace vct {

// The variance formulas; their names tell the kernels apart in a profile.
struct Centered {
  static constexpr bool kCentered = true;
};
struct SinglePass {
  static constexpr bool kCentered = false;
};

constexpr int kWarpPlaneThreads = 256;  // (a): eight planes a block
constexpr int kPlaneThreads = 256;      // (b)-(d): threads a CTA
constexpr int kPlaneWarps = kPlaneThreads / 32;
constexpr int kMaxCluster = 8;
constexpr long long kWarpPlaneBytes = 2 * 1024;
constexpr long long kBlockPlaneBytes = 32 * 1024;
constexpr long long kClusterShareBytes = 16 * 1024;
constexpr long long kClusterPlaneBytes = kMaxCluster * 2 * kClusterShareBytes;

// Regime codes (also reported by vct_in_plane_plan).
constexpr int kRegimeWarp = 0;
constexpr int kRegimeBlock = 1;
constexpr int kRegimeCluster = 2;
constexpr int kRegimeStream = 3;

struct PlanePlan {
  int regime;
  int vec;      // elements per load: 16 / sizeof(T), or 1
  int elems;    // elements a thread holds ((a)-(c))
  int cluster;  // CTAs per plane ((b)-(d))
  long long share;  // elements of the plane each CTA covers
};

inline long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }

// The smallest power-of-two multiple of `lo` that is at least `need`.
inline int elems_for(long long need, int lo) {
  int e = lo;
  while (e < need) e *= 2;
  return e;
}

// `tensors`: the planes of this size a thread holds its part of (1, or 2 for
// the backward's x and cotangent); the regimes' thresholds are in bytes of
// all of them.
inline PlanePlan plan_plane(long long hw, int elem_bytes, bool vector_ok,
                            int tensors = 1) {
  PlanePlan p;
  const int lo = 16 / elem_bytes;  // the smallest E: one 16-byte vector
  p.vec = vector_ok ? lo : 1;
  const long long bytes = hw * elem_bytes * tensors;
  if (bytes <= kWarpPlaneBytes) {
    p.regime = kRegimeWarp;
    p.elems = elems_for(ceil_div(hw, 32), lo);
    p.cluster = 1;
    p.share = hw;
  } else if (bytes <= kBlockPlaneBytes) {
    p.regime = kRegimeBlock;
    p.elems = elems_for(ceil_div(hw, kPlaneThreads), lo);
    p.cluster = 1;
    p.share = hw;
  } else if (bytes <= kClusterPlaneBytes) {
    p.regime = kRegimeCluster;
    long long c = ceil_div(bytes, kClusterShareBytes);
    if (c > kMaxCluster) c = kMaxCluster;
    p.elems = elems_for(ceil_div(hw, c * kPlaneThreads), lo);
    p.share = (long long)kPlaneThreads * p.elems;
    p.cluster = (int)ceil_div(hw, p.share);
  } else {
    p.regime = kRegimeStream;
    p.elems = 0;
    p.cluster = kMaxCluster;
    p.share = ceil_div(ceil_div(hw, kMaxCluster), lo) * lo;
  }
  return p;
}

// One load of T as it lies in memory: a 16-byte vector (V > 1) or one
// element. A thread holds its part of the plane in this form, so a bf16
// element takes half a register.
template <typename T, int V>
using Raw = typename std::conditional<V == 1, T, uint4>::type;

template <int V, typename T>
__device__ __forceinline__ Raw<T, V> load_raw(const T* __restrict__ p) {
  if constexpr (V == 1) {
    return *p;
  } else {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
}

// The V values of a load in f32.
template <int V, typename T>
__device__ __forceinline__ void unpack(const Raw<T, V>& r, float* v) {
  if constexpr (V == 1) {
    v[0] = load_f(&r, 0);
  } else if constexpr (sizeof(T) == 4) {
    const float4 q = reinterpret_cast<const float4&>(r);
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(h[k]);
      v[2 * k] = f.x;
      v[2 * k + 1] = f.y;
    }
  }
}

// V f32 values to p (16-byte aligned when V > 1), rounded to T.
template <int V, typename T>
__device__ __forceinline__ void store_vec(T* __restrict__ p, const float* v) {
  if constexpr (V == 1) {
    store_f(p, 0, v[0]);
  } else if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    uint4 q;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&q);
#pragma unroll
    for (int k = 0; k < 4; ++k) h[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
    *reinterpret_cast<uint4*>(p) = q;
  }
}

// The activation over N values, with one branch for all of them.
template <int N>
__device__ __forceinline__ void activate_all(float* v, int act) {
  switch (act) {
    case kRelu:
#pragma unroll
      for (int k = 0; k < N; ++k) v[k] = v[k] < 0.f ? 0.f : v[k];
      break;
    case kLeakyRelu:
#pragma unroll
      for (int k = 0; k < N; ++k) v[k] = v[k] >= 0.f ? v[k] : 0.2f * v[k];
      break;
    case kTanh:
#pragma unroll
      for (int k = 0; k < N; ++k) v[k] = tanhf(v[k]);
      break;
    case kSigmoid:
#pragma unroll
      for (int k = 0; k < N; ++k) v[k] = 1.f / (1.f + expf(-v[k]));
      break;
    default:  // identity
      break;
  }
}

// h of one load in f32: act(x) for act_norm, else x.
template <int V, typename T>
__device__ __forceinline__ void unpack_h(const Raw<T, V>& r, float* v, int act,
                                         int act_norm) {
  unpack<V, T>(r, v);
  if (act_norm) activate_all<V>(v, act);
}

// The sums over each group of L adjacent lanes (L a power of two up to 32),
// by a butterfly: every lane of a group holds its group's sums. All lanes of
// the warp take part.
template <int L>
__device__ __forceinline__ float2 lanes_sum2(float2 v) {
#pragma unroll
  for (int o = L / 2; o > 0; o >>= 1) {
    v.x += __shfl_xor_sync(0xffffffffu, v.x, o);
    v.y += __shfl_xor_sync(0xffffffffu, v.y, o);
  }
  return v;
}

__device__ __forceinline__ float2 warp_sum2(float2 v) {
  return lanes_sum2<32>(v);  // every lane holds the same sums
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// Regime (a): the warp's sums are the plane's.
struct WarpSums {
  __device__ __forceinline__ float2 operator()(float2 v, int) const {
    return warp_sum2(v);
  }
};

// Regimes (b)-(d): the CTA's sums, then, in a cluster, every rank's in rank
// order. `slot` (0 or 1) keeps K1's two exchanges apart, so no shared word
// is written twice.
struct CtaSums {
  float2* warps;  // [2][kPlaneWarps] shared
  float2* pub;    // [2] shared: this CTA's sums, read by the cluster
  int cluster;    // CTAs per plane (1: no exchange)

  __device__ __forceinline__ float2 operator()(float2 v, int slot) const {
    v = warp_sum2(v);
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    if (lane == 0) warps[slot * kPlaneWarps + warp] = v;
    __syncthreads();
    float2 t = make_float2(0.f, 0.f);
#pragma unroll
    for (int w = 0; w < kPlaneWarps; ++w) {
      const float2 q = warps[slot * kPlaneWarps + w];
      t.x += q.x;
      t.y += q.y;
    }
    if (cluster == 1) return t;
    cooperative_groups::cluster_group cl = cooperative_groups::this_cluster();
    if (threadIdx.x == 0) pub[slot] = t;
    cl.sync();
    t = make_float2(0.f, 0.f);
    for (int r = 0; r < cluster; ++r) {
      const float2 q = *cl.map_shared_rank(pub + slot, (unsigned)r);
      t.x += q.x;
      t.y += q.y;
    }
    return t;
  }
};

// mean and rsqrt(var + eps) from the plane's sums (s, ss); for Centered, ss
// is the sum of (h - mean)^2 and s is unused.
template <class Var>
__device__ __forceinline__ float2 stats_of(float mean, float ss, float count,
                                           float eps) {
  const float var = Var::kCentered ? ss / count
                                   : fmaxf(ss / count - mean * mean, 0.f);
  return make_float2(mean, rsqrtf(var + eps));
}

// A thread's loads of a plane, held in registers: as loaded (kPacked: a
// bf16 element takes half a register; each pass unpacks again) or as h in
// f32 (unpacked once).
template <bool kPacked, typename T, int V, int kLoads>
struct Held {
  Raw<T, V> raw[kLoads];
  __device__ __forceinline__ void put(int k, const Raw<T, V>& r, int, int) {
    raw[k] = r;
  }
  __device__ __forceinline__ void get(int k, float* v, int act,
                                      int act_norm) const {
    unpack_h<V, T>(raw[k], v, act, act_norm);
  }
};

template <typename T, int V, int kLoads>
struct Held<false, T, V, kLoads> {
  float h[kLoads * V];
  __device__ __forceinline__ void put(int k, const Raw<T, V>& r, int act,
                                      int act_norm) {
    unpack_h<V, T>(r, h + k * V, act, act_norm);
  }
  __device__ __forceinline__ void get(int k, float* v, int, int) const {
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] = h[k * V + j];
  }
};

// A thread's loads of a plane into `held`: the elements begin + (t + P * k)
// * V + j (k < kLoads, j < V) below `end`, every load issued before any is
// used, so kLoads of them are in flight. Returns n: the valid loads are a
// prefix, k < n.
template <bool kPacked, typename T, int V, int kLoads>
__device__ __forceinline__ int load_held(Held<kPacked, T, V, kLoads>& held,
                                         const T* __restrict__ x,
                                         long long begin, long long end, int t,
                                         int P, int act, int act_norm) {
  int n = 0;
#pragma unroll
  for (int k = 0; k < kLoads; ++k) {
    const long long i = begin + ((long long)t + (long long)P * k) * V;
    if (i < end) {
      held.put(k, load_raw<V>(x + i), act, act_norm);
      n = k + 1;
    }
  }
  return n;
}

// The sums (s, ss) of the n held loads in load order; ss only with kSquares.
template <bool kSquares, bool kPacked, typename T, int V, int kLoads>
__device__ __forceinline__ float2 held_sums(
    const Held<kPacked, T, V, kLoads>& held, int n, int act, int act_norm) {
  float2 acc = make_float2(0.f, 0.f);
#pragma unroll
  for (int k = 0; k < kLoads; ++k) {
    if (k < n) {
      float v[V];
      held.get(k, v, act, act_norm);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        acc.x += v[j];
        if (kSquares) acc.y += v[j] * v[j];
      }
    }
  }
  return acc;
}

// y = (h - st.x) * st.y, the activation after it for norm_act, of the n held
// loads, stored where load_held read them.
template <bool kPacked, typename T, int V, int kLoads>
__device__ __forceinline__ void store_held(
    const Held<kPacked, T, V, kLoads>& held, int n, T* __restrict__ y,
    long long begin, int t, int P, float2 st, int act, int act_norm) {
#pragma unroll
  for (int k = 0; k < kLoads; ++k) {
    if (k < n) {
      float v[V];
      held.get(k, v, act, act_norm);
#pragma unroll
      for (int j = 0; j < V; ++j) v[j] = (v[j] - st.x) * st.y;
      if (!act_norm) activate_all<V>(v, act);
      const long long i = begin + ((long long)t + (long long)P * k) * V;
      store_vec<V>(y + i, v);
    }
  }
}

// One thread's part of a plane held in registers (load_held). Takes the
// plane's (mean, rsqrt(var + eps)) through `sums` from h = act(x) (act_norm)
// or x, then normalizes the held values and stores them.
template <class Var, int V, int E, bool kPacked, typename T, class Sums>
__device__ __forceinline__ void resident_plane(
    const T* __restrict__ x, T* __restrict__ y, long long begin, long long end,
    int t, int P, int act, int act_norm, float count, float eps,
    const Sums& sums, bool cluster) {
  constexpr int kLoads = E / V;
  Held<kPacked, T, V, kLoads> held;
  const int n = load_held(held, x, begin, end, t, P, act, act_norm);
  float2 acc = held_sums<!Var::kCentered>(held, n, act, act_norm);
  float2 st;
  if constexpr (Var::kCentered) {
    const float mean = sums(acc, 0).x / count;
    float ss = 0.f;
#pragma unroll
    for (int k = 0; k < kLoads; ++k) {
      if (k < n) {
        float v[V];
        held.get(k, v, act, act_norm);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float d = v[j] - mean;
          ss += d * d;
        }
      }
    }
    st = stats_of<Var>(mean, sums(make_float2(ss, 0.f), 1).x, count, eps);
  } else {
    acc = sums(acc, 0);
    st = stats_of<Var>(acc.x / count, acc.y, count, eps);
  }
  if (cluster) cluster_arrive();  // done reading the peers' shared memory
  store_held(held, n, y, begin, t, P, st, act, act_norm);
  if (cluster) cluster_wait();  // the peers are done reading ours
}

// (a): warp w of block b normalizes plane 8 b + w.
template <class Var, typename T, int V, int E>
__global__ void __launch_bounds__(kWarpPlaneThreads)
    warp_plane_kernel(const T* __restrict__ x, T* __restrict__ y,
                      long long planes, long long hw, int act, int act_norm,
                      float eps) {
  const long long plane = (long long)blockIdx.x * (kWarpPlaneThreads / 32) +
                          (threadIdx.x >> 5);
  if (plane >= planes) return;  // no block barrier follows
  const long long base = plane * hw;
  resident_plane<Var, V, E, false>(x + base, y + base, 0, hw,
                                   threadIdx.x & 31, 32, act, act_norm,
                                   (float)hw, eps, WarpSums{}, false);
}

// (b) and (c): `cluster` consecutive CTAs per plane (a cluster launch when
// cluster > 1), CTA r holding elements [r * share, (r + 1) * share).
template <class Var, typename T, int V, int E>
__global__ void __launch_bounds__(kPlaneThreads)
    cta_plane_kernel(const T* __restrict__ x, T* __restrict__ y, long long hw,
                     long long share, int cluster, int act, int act_norm,
                     float eps) {
  __shared__ float2 warps[2 * kPlaneWarps];
  __shared__ float2 pub[2];
  const long long plane = blockIdx.x / cluster;
  const long long rank = blockIdx.x % cluster;
  const long long base = plane * hw;
  const long long begin = rank * share;
  const long long end = begin + share < hw ? begin + share : hw;
  resident_plane<Var, V, E, true>(x + base, y + base, begin, end,
                                  threadIdx.x, kPlaneThreads, act, act_norm,
                                  (float)hw, eps, CtaSums{warps, pub, cluster},
                                  cluster > 1);
}

// h = act(x) for act_norm, else x, for the V elements at p.
template <int V, typename T>
__device__ __forceinline__ void load_h(const T* __restrict__ p, float* v,
                                       int act, int act_norm) {
  unpack_h<V, T>(load_raw<V>(p), v, act, act_norm);
}

// (d)'s loop over a CTA's share [begin, end) of a plane in device memory:
// thread t takes the vectors begin + (t + kPlaneThreads * i) * V, kStreamLoads
// of them loaded per trip before any is used. The elements are visited in the
// same order as with one load a trip, so the sums do not depend on it.
constexpr int kStreamLoads = 4;

// The sums (s, ss) of h over the share; ss only with kSquares.
template <bool kSquares, int V, typename T>
__device__ __forceinline__ float2 stream_sums(const T* __restrict__ p,
                                              long long begin, long long end,
                                              int act, int act_norm) {
  const long long step = (long long)kPlaneThreads * V;
  float2 acc = make_float2(0.f, 0.f);
  for (long long i = begin + (long long)threadIdx.x * V; i < end;
       i += kStreamLoads * step) {
    Raw<T, V> r[kStreamLoads];
#pragma unroll
    for (int u = 0; u < kStreamLoads; ++u)
      if (i + u * step < end) r[u] = load_raw<V>(p + i + u * step);
#pragma unroll
    for (int u = 0; u < kStreamLoads; ++u) {
      if (i + u * step < end) {
        float v[V];
        unpack_h<V, T>(r[u], v, act, act_norm);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          acc.x += v[j];
          if (kSquares) acc.y += v[j] * v[j];
        }
      }
    }
  }
  return acc;
}

// o = (h - st.x) * st.y over the share, the activation after it for
// norm_act.
template <int V, typename T>
__device__ __forceinline__ void stream_store(const T* __restrict__ p,
                                             T* __restrict__ o,
                                             long long begin, long long end,
                                             float2 st, int act,
                                             int act_norm) {
  const long long step = (long long)kPlaneThreads * V;
  for (long long i = begin + (long long)threadIdx.x * V; i < end;
       i += kStreamLoads * step) {
    Raw<T, V> r[kStreamLoads];
#pragma unroll
    for (int u = 0; u < kStreamLoads; ++u)
      if (i + u * step < end) r[u] = load_raw<V>(p + i + u * step);
#pragma unroll
    for (int u = 0; u < kStreamLoads; ++u) {
      if (i + u * step < end) {
        float v[V];
        unpack_h<V, T>(r[u], v, act, act_norm);
#pragma unroll
        for (int j = 0; j < V; ++j) v[j] = (v[j] - st.x) * st.y;
        if (!act_norm) activate_all<V>(v, act);
        store_vec<V>(o + i + u * step, v);
      }
    }
  }
}

// (d): a cluster of kMaxCluster CTAs per plane, each looping over its share
// [r * share, (r + 1) * share) in device memory.
template <class Var, typename T, int V>
__global__ void __launch_bounds__(kPlaneThreads)
    stream_plane_kernel(const T* __restrict__ x, T* __restrict__ y,
                        long long hw, long long share, int act, int act_norm,
                        float eps) {
  __shared__ float2 warps[2 * kPlaneWarps];
  __shared__ float2 pub[2];
  const CtaSums sums{warps, pub, kMaxCluster};
  const long long plane = blockIdx.x / kMaxCluster;
  const long long begin = (blockIdx.x % kMaxCluster) * share;
  const long long end = begin + share < hw ? begin + share : hw;
  const T* p = x + plane * hw;
  T* o = y + plane * hw;
  const float count = (float)hw;
  float2 acc =
      stream_sums<!Var::kCentered, V>(p, begin, end, act, act_norm);
  float2 st;
  if constexpr (Var::kCentered) {
    const float mean = sums(acc, 0).x / count;
    const long long step = (long long)kPlaneThreads * V;
    float ss = 0.f;
    for (long long i = begin + (long long)threadIdx.x * V; i < end; i += step) {
      float v[V];
      load_h<V>(p + i, v, act, act_norm);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float d = v[j] - mean;
        ss += d * d;
      }
    }
    st = stats_of<Var>(mean, sums(make_float2(ss, 0.f), 1).x, count, eps);
  } else {
    acc = sums(acc, 0);
    st = stats_of<Var>(acc.x / count, acc.y, count, eps);
  }
  cluster_arrive();
  stream_store<V>(p, o, begin, end, st, act, act_norm);
  cluster_wait();
}

// A launch of `blocks` CTAs of `threads`, as clusters of `cluster` CTAs when
// cluster > 1. Returns the launch's error.
template <typename... Params, typename... Args>
cudaError_t launch_grid(void (*kernel)(Params...), long long blocks,
                        int threads, int cluster, cudaStream_t stream,
                        Args&&... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, kernel, std::forward<Args>(args)...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// launch(std::integral_constant<int, E>()) for E = elems, the elements a
// thread holds in the plan: kLo (one 16-byte vector's elements) times 1, 2,
// 4 or, for (b) and (c), 8.
template <int kLo, class Launch>
cudaError_t with_elems(const PlanePlan& p, Launch&& launch) {
  const int e = p.elems / kLo;
  if (p.elems % kLo == 0) {
    if (e == 1) return launch(std::integral_constant<int, kLo>());
    if (e == 2) return launch(std::integral_constant<int, 2 * kLo>());
    if (e == 4) return launch(std::integral_constant<int, 4 * kLo>());
    if (e == 8 && p.regime != kRegimeWarp)
      return launch(std::integral_constant<int, 8 * kLo>());
  }
  return cudaErrorInvalidValue;
}

// CTAs of a launch of the plan over `planes` planes: eight planes a block in
// (a), `cluster` CTAs a plane beyond.
inline long long plan_blocks(const PlanePlan& p, long long planes) {
  return p.regime == kRegimeWarp ? ceil_div(planes, kWarpPlaneThreads / 32)
                                 : planes * p.cluster;
}

// The plan's kernel (E = p.elems).
template <class Var, typename T, int V>
cudaError_t launch_vec(const PlanePlan& p, const T* x, T* y, long long planes,
                       long long hw, int act, int act_norm, float eps,
                       cudaStream_t stream) {
  const long long blocks = plan_blocks(p, planes);
  if (p.regime == kRegimeStream)
    return launch_grid(stream_plane_kernel<Var, T, V>, blocks, kPlaneThreads,
                       kMaxCluster, stream, x, y, hw, p.share, act, act_norm,
                       eps);
  return with_elems<16 / (int)sizeof(T)>(p, [&](auto e) {
    constexpr int E = decltype(e)::value;
    if (p.regime == kRegimeWarp) {
      if constexpr (E <= 4 * 16 / (int)sizeof(T))
        return launch_grid(warp_plane_kernel<Var, T, V, E>, blocks,
                           kWarpPlaneThreads, 1, stream, x, y, planes, hw, act,
                           act_norm, eps);
    }
    return launch_grid(cta_plane_kernel<Var, T, V, E>, blocks, kPlaneThreads,
                       p.cluster, stream, x, y, hw, p.share, p.cluster, act,
                       act_norm, eps);
  });
}

inline bool vector_ok(const void* x, const void* y, long long hw,
                      int elem_bytes) {
  return reinterpret_cast<std::uintptr_t>(x) % 16 == 0 &&
         reinterpret_cast<std::uintptr_t>(y) % 16 == 0 &&
         hw % (16 / elem_bytes) == 0;
}

template <class Var, typename T>
cudaError_t launch_typed(const void* x, void* y, long long planes,
                         long long hw, int act, int act_norm, float eps,
                         cudaStream_t stream) {
  const bool vec = vector_ok(x, y, hw, (int)sizeof(T));
  const PlanePlan p = plan_plane(hw, (int)sizeof(T), vec);
  if (plan_blocks(p, planes) > INT_MAX) return cudaErrorInvalidValue;
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  if (vec)
    return launch_vec<Var, T, 16 / (int)sizeof(T)>(p, xt, yt, planes, hw, act,
                                                   act_norm, eps, stream);
  return launch_vec<Var, T, 1>(p, xt, yt, planes, hw, act, act_norm, eps,
                               stream);
}

// The C entry points' body: x, y contiguous (planes, hw) views of NCHW
// tensors (planes = N*C, hw = H*W); dtype kFloat32 or kBFloat16; act kRelu ..
// kIdentity; act_norm 1 = activation then norm, 0 = norm then activation.
// Returns the cudaError_t of the launch (0 = success).
template <class Var>
int in_plane(const void* x, void* y, long long planes, long long hw,
             int dtype, int act, int act_norm, float eps, void* stream) {
  if (planes <= 0 || planes > INT_MAX || hw <= 0 || act < 0 ||
      act > kIdentity)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return (int)launch_typed<Var, float>(x, y, planes, hw, act, act_norm, eps,
                                         s);
  if (dtype == kBFloat16)
    return (int)launch_typed<Var, __nv_bfloat16>(x, y, planes, hw, act,
                                                 act_norm, eps, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace vct
