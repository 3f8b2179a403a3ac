// The gradient of fused InstanceNorm + activation (K1's op) with respect to
// its input, over the (n, c) planes of an NCHW tensor: dx from x and the
// cotangent g alone, the statistics recomputed from x, CENTERED, in f32.
//
// Replaces no TPU kernel: the JAX package's VJPs of the IN+act kernels are
// jnp (vae_cyclegan_tpu/ops/instance_norm.py::_fused_tpu_bwd), left to XLA,
// which fuses them on the TPU. On the card the same formula in plain PyTorch
// (ops/instance_norm.py::fused_backward, this kernel's plain version) is
// about eighteen launches of f32 temporaries and casts a site, ~120 bytes
// moved per element; this kernel is one launch. Per plane, with h = act(x)
// for act_norm (else x):
//
//   mean = E[h], r = rsqrt(E[(h - mean)^2] + eps), hh = (h - mean) * r
//   norm_act: d = g * act'(hh);  act_norm: d = g
//   dx = r * (d - E[d] - hh * E[d * hh]), times act'(x) for act_norm
//
// and one rounding of dx to the input type at the end.
//
// What bounds it: device-memory bytes. x and g are read once and dx written
// once (6 bytes an element in bf16), a few tens of f32 flops an element.
//
// Design: in_plane.cuh's plane core. Each thread loads its part of the x and
// g planes into registers as loaded (bf16 packed two to a register), every
// load issued before any is used, then makes four passes over what it holds
// with three fixed-order exchanges in the plane's warp, CTA or cluster
// between them: the mean; the centered sum of squares (as K1 computes them);
// (sum d, sum d * hh) packed into one float2; then it writes dx. The regime
// is chosen by the bytes of x and g together, so every threshold sits at
// half the plane of the forward's: bf16 16x16 a warp, 32x32 and 64x64 a CTA,
// 128x128 a cluster of 4 and 256x256 a cluster of 8 CTAs (16 KB of the two
// planes a CTA); planes over 256 KB together (f32 256x256) loop over device
// memory in a cluster of 8, reading x four times and g twice. No atomics:
// a launch repeats bit for bit.
//
// Timed on an H100 (bf16, batch 24, the path's planes, in turns, each
// variant alone): 32 KB of the two planes a CTA beat 16 KB by 20% at
// 128x128 and tied at 256x256; asking ptxas for three CTAs an SM (80
// registers in place of 98) beat two by 25% at 256x256 and tied elsewhere;
// the cluster's partials read by one warp's lanes in parallel gained under
// 5%. None is taken yet: the first two were not timed together.

#include "in_plane.cuh"

namespace vct {
namespace {

// v := act(v), d := act'(v) at the V values (ops/instance_norm.py's
// _act_and_grad), with one branch for all of them.
template <int V>
__device__ __forceinline__ void act_and_grad(float* v, float* d, int act) {
  switch (act) {
    case kRelu:
#pragma unroll
      for (int k = 0; k < V; ++k) {
        d[k] = v[k] > 0.f ? 1.f : 0.f;
        v[k] = v[k] < 0.f ? 0.f : v[k];
      }
      break;
    case kLeakyRelu:
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const bool pos = v[k] >= 0.f;
        d[k] = pos ? 1.f : 0.2f;
        v[k] = pos ? v[k] : 0.2f * v[k];
      }
      break;
    case kTanh:
#pragma unroll
      for (int k = 0; k < V; ++k) {
        v[k] = tanhf(v[k]);
        d[k] = 1.f - v[k] * v[k];
      }
      break;
    case kSigmoid:
#pragma unroll
      for (int k = 0; k < V; ++k) {
        v[k] = 1.f / (1.f + expf(-v[k]));
        d[k] = v[k] * (1.f - v[k]);
      }
      break;
    default:  // identity
#pragma unroll
      for (int k = 0; k < V; ++k) d[k] = 1.f;
      break;
  }
}

// The plane's moments as the passes need them: mean and r of h from the
// first two exchanges (all d_of reads), E[d] and E[d * hh] from the third.
struct Moments {
  float mean, r;
  float md, mdh;
};

// h of V values of x (in f32, in v) and, for act_norm, act'(x) in a.
template <int V>
__device__ __forceinline__ void h_of(float* v, float* a, int act,
                                     int act_norm) {
  if (act_norm) act_and_grad<V>(v, a, act);
}

// From x's V values v (h in place, as h_of leaves them) and g's gv: hh in v
// and d in gv, and for act_norm act'(x) stays in a.
template <int V>
__device__ __forceinline__ void d_of(float* v, float* gv, float* a,
                                     const Moments& m, int act,
                                     int act_norm) {
#pragma unroll
  for (int j = 0; j < V; ++j) v[j] = (v[j] - m.mean) * m.r;
  if (!act_norm) {
    float t[V], dact[V];
#pragma unroll
    for (int j = 0; j < V; ++j) t[j] = v[j];
    act_and_grad<V>(t, dact, act);
#pragma unroll
    for (int j = 0; j < V; ++j) gv[j] *= dact[j];
  }
}

// dx of V values from hh (v), d (gv) and act'(x) (a, act_norm).
template <int V>
__device__ __forceinline__ void dx_of(float* v, const float* gv,
                                      const float* a, const Moments& m,
                                      int act_norm) {
#pragma unroll
  for (int j = 0; j < V; ++j) {
    v[j] = m.r * (gv[j] - m.md - v[j] * m.mdh);
    if (act_norm) v[j] *= a[j];
  }
}

// One thread's part of a plane: x and g held in registers as loaded
// (load_held), the three exchanges through `sums` (slots 0, 1, 2), dx stored
// where x was read.
template <int V, int E, typename T, class Sums>
__device__ __forceinline__ void resident_bwd(
    const T* __restrict__ x, const T* __restrict__ g, T* __restrict__ dx,
    long long begin, long long end, int t, int P, int act, int act_norm,
    float count, float eps, const Sums& sums, bool cluster) {
  constexpr int kLoads = E / V;
  Held<true, T, V, kLoads> hx, hg;
  const int n = load_held(hx, x, begin, end, t, P, 0, 0);
  load_held(hg, g, begin, end, t, P, 0, 0);
  Moments m;
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < kLoads; ++k) {
    if (k < n) {
      float v[V], a[V];
      hx.get(k, v, 0, 0);
      h_of<V>(v, a, act, act_norm);
#pragma unroll
      for (int j = 0; j < V; ++j) s += v[j];
    }
  }
  m.mean = sums(make_float2(s, 0.f), 0).x / count;
  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < kLoads; ++k) {
    if (k < n) {
      float v[V], a[V];
      hx.get(k, v, 0, 0);
      h_of<V>(v, a, act, act_norm);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float c = v[j] - m.mean;
        ss += c * c;
      }
    }
  }
  m.r = stats_of<Centered>(m.mean, sums(make_float2(ss, 0.f), 1).x, count,
                           eps).y;
  float2 acc = make_float2(0.f, 0.f);
#pragma unroll
  for (int k = 0; k < kLoads; ++k) {
    if (k < n) {
      float v[V], gv[V], a[V];
      hx.get(k, v, 0, 0);
      hg.get(k, gv, 0, 0);
      h_of<V>(v, a, act, act_norm);
      d_of<V>(v, gv, a, m, act, act_norm);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        acc.x += gv[j];
        acc.y += gv[j] * v[j];
      }
    }
  }
  acc = sums(acc, 2);
  m.md = acc.x / count;
  m.mdh = acc.y / count;
  if (cluster) cluster_arrive();  // done reading the peers' shared memory
#pragma unroll
  for (int k = 0; k < kLoads; ++k) {
    if (k < n) {
      float v[V], gv[V], a[V];
      hx.get(k, v, 0, 0);
      hg.get(k, gv, 0, 0);
      h_of<V>(v, a, act, act_norm);
      d_of<V>(v, gv, a, m, act, act_norm);
      dx_of<V>(v, gv, a, m, act_norm);
      store_vec<V>(dx + begin + ((long long)t + (long long)P * k) * V, v);
    }
  }
  if (cluster) cluster_wait();  // the peers are done reading ours
}

// (a): warp w of block b takes plane 8 b + w.
template <typename T, int V, int E>
__global__ void __launch_bounds__(kWarpPlaneThreads)
    warp_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g,
                    T* __restrict__ dx, long long planes, long long hw,
                    int act, int act_norm, float eps) {
  const long long plane = (long long)blockIdx.x * (kWarpPlaneThreads / 32) +
                          (threadIdx.x >> 5);
  if (plane >= planes) return;  // no block barrier follows
  const long long base = plane * hw;
  resident_bwd<V, E>(x + base, g + base, dx + base, 0, hw, threadIdx.x & 31,
                     32, act, act_norm, (float)hw, eps, WarpSums{}, false);
}

// (b) and (c): `cluster` consecutive CTAs per plane (a cluster launch when
// cluster > 1), CTA r holding elements [r * share, (r + 1) * share).
template <typename T, int V, int E>
__global__ void __launch_bounds__(kPlaneThreads)
    cta_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g,
                   T* __restrict__ dx, long long hw, long long share,
                   int cluster, int act, int act_norm, float eps) {
  __shared__ float2 warps[3 * kPlaneWarps];
  __shared__ float2 pub[3];
  const long long plane = blockIdx.x / cluster;
  const long long rank = blockIdx.x % cluster;
  const long long base = plane * hw;
  const long long begin = rank * share;
  const long long end = begin + share < hw ? begin + share : hw;
  resident_bwd<V, E>(x + base, g + base, dx + base, begin, end, threadIdx.x,
                     kPlaneThreads, act, act_norm, (float)hw, eps,
                     CtaSums{warps, pub, cluster}, cluster > 1);
}

// (d): a cluster of kMaxCluster CTAs per plane, each looping over its share
// [r * share, (r + 1) * share) in device memory, one vector a thread a trip,
// in the order of the resident regimes' passes.
template <typename T, int V>
__global__ void __launch_bounds__(kPlaneThreads)
    stream_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g,
                      T* __restrict__ dx, long long hw, long long share,
                      int act, int act_norm, float eps) {
  __shared__ float2 warps[3 * kPlaneWarps];
  __shared__ float2 pub[3];
  const CtaSums sums{warps, pub, kMaxCluster};
  const long long plane = blockIdx.x / kMaxCluster;
  const long long begin = (blockIdx.x % kMaxCluster) * share;
  const long long end = begin + share < hw ? begin + share : hw;
  const T* px = x + plane * hw;
  const T* pg = g + plane * hw;
  T* o = dx + plane * hw;
  const float count = (float)hw;
  const long long first = begin + (long long)threadIdx.x * V;
  const long long step = (long long)kPlaneThreads * V;
  Moments m;
  float s = 0.f;
  for (long long i = first; i < end; i += step) {
    float v[V], a[V];
    unpack<V, T>(load_raw<V>(px + i), v);
    h_of<V>(v, a, act, act_norm);
#pragma unroll
    for (int j = 0; j < V; ++j) s += v[j];
  }
  m.mean = sums(make_float2(s, 0.f), 0).x / count;
  float ss = 0.f;
  for (long long i = first; i < end; i += step) {
    float v[V], a[V];
    unpack<V, T>(load_raw<V>(px + i), v);
    h_of<V>(v, a, act, act_norm);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float c = v[j] - m.mean;
      ss += c * c;
    }
  }
  m.r = stats_of<Centered>(m.mean, sums(make_float2(ss, 0.f), 1).x, count,
                           eps).y;
  float2 acc = make_float2(0.f, 0.f);
  for (long long i = first; i < end; i += step) {
    float v[V], gv[V], a[V];
    unpack<V, T>(load_raw<V>(px + i), v);
    unpack<V, T>(load_raw<V>(pg + i), gv);
    h_of<V>(v, a, act, act_norm);
    d_of<V>(v, gv, a, m, act, act_norm);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      acc.x += gv[j];
      acc.y += gv[j] * v[j];
    }
  }
  acc = sums(acc, 2);
  m.md = acc.x / count;
  m.mdh = acc.y / count;
  cluster_arrive();
  for (long long i = first; i < end; i += step) {
    float v[V], gv[V], a[V];
    unpack<V, T>(load_raw<V>(px + i), v);
    unpack<V, T>(load_raw<V>(pg + i), gv);
    h_of<V>(v, a, act, act_norm);
    d_of<V>(v, gv, a, m, act, act_norm);
    dx_of<V>(v, gv, a, m, act_norm);
    store_vec<V>(o + i, v);
  }
  cluster_wait();
}

constexpr int kBwdTensors = 2;  // x and g held together

// The plan's kernel, E = p.elems: kLo (one vector's elements) times 1, 2 or
// 4 (the two planes' bytes cap a thread's share at half the forward's).
template <typename T, int V>
cudaError_t launch_bwd_vec(const PlanePlan& p, const T* x, const T* g, T* dx,
                           long long planes, long long hw, int act,
                           int act_norm, float eps, cudaStream_t stream) {
  const long long blocks = plan_blocks(p, planes);
  if (p.regime == kRegimeStream)
    return launch_grid(stream_bwd_kernel<T, V>, blocks, kPlaneThreads,
                       kMaxCluster, stream, x, g, dx, hw, p.share, act,
                       act_norm, eps);
  constexpr int kLo = 16 / (int)sizeof(T);
  auto launch = [&](auto e) {
    constexpr int E = decltype(e)::value;
    if (p.regime == kRegimeWarp)
      return launch_grid(warp_bwd_kernel<T, V, E>, blocks, kWarpPlaneThreads,
                         1, stream, x, g, dx, planes, hw, act, act_norm, eps);
    return launch_grid(cta_bwd_kernel<T, V, E>, blocks, kPlaneThreads,
                       p.cluster, stream, x, g, dx, hw, p.share, p.cluster,
                       act, act_norm, eps);
  };
  if (p.elems == kLo) return launch(std::integral_constant<int, kLo>());
  if (p.elems == 2 * kLo)
    return launch(std::integral_constant<int, 2 * kLo>());
  if (p.elems == 4 * kLo)
    return launch(std::integral_constant<int, 4 * kLo>());
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch_bwd(const void* x, const void* g, void* dx,
                       long long planes, long long hw, int act, int act_norm,
                       float eps, cudaStream_t stream) {
  const bool vec = vector_ok(x, dx, hw, (int)sizeof(T)) &&
                   reinterpret_cast<std::uintptr_t>(g) % 16 == 0;
  const PlanePlan p = plan_plane(hw, (int)sizeof(T), vec, kBwdTensors);
  if (plan_blocks(p, planes) > INT_MAX) return cudaErrorInvalidValue;
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(g);
  T* dt = static_cast<T*>(dx);
  if (vec)
    return launch_bwd_vec<T, 16 / (int)sizeof(T)>(p, xt, gt, dt, planes, hw,
                                                  act, act_norm, eps, stream);
  return launch_bwd_vec<T, 1>(p, xt, gt, dt, planes, hw, act, act_norm, eps,
                              stream);
}

}  // namespace
}  // namespace vct

// x, g, dx: contiguous (planes, hw) views of NCHW tensors of one dtype
// (planes = N*C, hw = H*W); g the cotangent of K1's y. dtype: vct::kFloat32
// or vct::kBFloat16. act: vct::kRelu..vct::kIdentity. act_norm: 1 =
// activation then norm, 0 = norm then activation. Returns the cudaError_t of
// the launch (0 = success).
extern "C" int vct_in_act_bwd(const void* x, const void* g, void* dx,
                              long long planes, long long hw, int dtype,
                              int act, int act_norm, float eps,
                              void* stream) {
  if (planes <= 0 || planes > INT_MAX || hw <= 0 || act < 0 ||
      act > vct::kIdentity)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == vct::kFloat32)
    return (int)vct::launch_bwd<float>(x, g, dx, planes, hw, act, act_norm,
                                       eps, s);
  if (dtype == vct::kBFloat16)
    return (int)vct::launch_bwd<__nv_bfloat16>(x, g, dx, planes, hw, act,
                                               act_norm, eps, s);
  return (int)cudaErrorInvalidValue;
}

// The plan vct_in_act_bwd takes for planes of `hw` elements of `dtype`, as
// vct_in_plane_plan reports the forward's: out = {regime (0 warp, 1 block, 2
// cluster, 3 stream), elements per load, elements of each plane a thread
// holds, CTAs per plane}. Returns 0, or -1 for a bad dtype.
extern "C" int vct_in_act_bwd_plan(long long hw, int dtype, int vector_ok,
                                   int* out) {
  if (hw <= 0 || (dtype != vct::kFloat32 && dtype != vct::kBFloat16))
    return -1;
  const vct::PlanePlan p = vct::plan_plane(
      hw, dtype == vct::kFloat32 ? 4 : 2, vector_ok != 0, vct::kBwdTensors);
  out[0] = p.regime;
  out[1] = p.vec;
  out[2] = p.elems;
  out[3] = p.cluster;
  return 0;
}
