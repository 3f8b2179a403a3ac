// Fused InstanceNorm + activation in two passes over the (n, c) planes of an
// NCHW tensor, for planes of any size.
//
// Replaces vae_cyclegan_tpu/ops/instance_norm.py::_pallas_in_act_tiled (its two
// pallas_calls, _stats_kernel and _apply_kernel). Per plane, in f32: the sum s
// and the sum of squares ss of h (h = act(x) for act_norm, else x), then
// mu = s / hw, var = max(ss / hw - mu^2, 0) (the single-pass variance of the
// TPU kernel, not the centered one of in_act.cu), y = (h - mu) * rsqrt(var +
// eps), the activation after the norm for norm_act, and one rounding to the
// input type at the end: between the activation and the norm nothing is
// rounded.
//
// What bounds it: device-memory bytes. x is read twice (once per pass) and y
// written once, with a handful of flops per element; at the training path's
// big planes (256x256 and 128x128) a call moves tens of MB.
//
// Design: the TPU kernel walks the HW tiles of a sample in order and carries
// the sums in its output block from one grid step to the next; Hopper's blocks
// run in no order, so the carry becomes a second pass. Each plane is cut into
// chunks of kChunk elements, one block per (plane, chunk):
//   1. stats_kernel reduces its chunk to (s, ss) and writes the pair to an f32
//      scratch buffer (no atomics);
//   2. apply_kernel sums its plane's pairs in chunk order (every block of a
//      plane repeats the same sum, so they agree to the bit), forms mu and
//      rsqrt(var + eps), and normalizes its chunk.
// Every sum is taken in a fixed order, so the output repeats bit for bit.
// Loads and stores are 16 bytes a thread (4 floats or 8 bf16) when both
// pointers are 16-byte aligned and hw is a multiple of the vector width, else
// one element a thread.

#include <climits>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr long long kChunk = 4096;

// V consecutive elements from p (16-byte aligned when V > 1) as f32.
template <int V, typename T>
__device__ __forceinline__ void load_vec(const T* __restrict__ p, float* v) {
  if constexpr (V == 1) {
    v[0] = vct::load_f(p, 0);
  } else if constexpr (sizeof(T) == 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
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
    vct::store_f(p, 0, v[0]);
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

// One block per (plane, chunk), blockIdx.x = plane * chunks + chunk. Writes
// (s, ss) of h over the chunk to partial[2 * blockIdx.x + {0, 1}].
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    stats_kernel(const T* __restrict__ x, float* __restrict__ partial,
                 long long hw, int chunks, int act, int act_norm) {
  __shared__ float scratch[kThreads / 32];
  const long long plane = blockIdx.x / chunks;
  const long long begin = (long long)(blockIdx.x % chunks) * kChunk;
  const long long end = begin + kChunk < hw ? begin + kChunk : hw;
  const T* p = x + plane * hw;
  float s = 0.f, ss = 0.f;
  for (long long i = begin + (long long)threadIdx.x * V; i < end;
       i += (long long)kThreads * V) {
    float v[V];
    load_vec<V>(p + i, v);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float h = act_norm ? vct::activate(v[k], act) : v[k];
      s += h;
      ss += h * h;
    }
  }
  s = vct::block_sum(s, scratch);
  ss = vct::block_sum(ss, scratch);
  if (threadIdx.x == 0) {
    partial[2 * (long long)blockIdx.x] = s;
    partial[2 * (long long)blockIdx.x + 1] = ss;
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    apply_kernel(const T* __restrict__ x, const float* __restrict__ partial,
                 T* __restrict__ y, long long hw, int chunks, int act,
                 int act_norm, float eps) {
  __shared__ float stats[2];
  const long long plane = blockIdx.x / chunks;
  const long long begin = (long long)(blockIdx.x % chunks) * kChunk;
  const long long end = begin + kChunk < hw ? begin + kChunk : hw;
  if (threadIdx.x == 0) {
    const float* q = partial + 2 * plane * chunks;
    float s = 0.f, ss = 0.f;
    for (int c = 0; c < chunks; ++c) {
      s += q[2 * c];
      ss += q[2 * c + 1];
    }
    const float count = (float)hw;
    const float mu = s / count;
    const float var = fmaxf(ss / count - mu * mu, 0.f);
    stats[0] = mu;
    stats[1] = rsqrtf(var + eps);
  }
  __syncthreads();
  const float mu = stats[0];
  const float r = stats[1];
  const T* p = x + plane * hw;
  T* o = y + plane * hw;
  for (long long i = begin + (long long)threadIdx.x * V; i < end;
       i += (long long)kThreads * V) {
    float v[V];
    load_vec<V>(p + i, v);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float h = act_norm ? vct::activate(v[k], act) : v[k];
      const float n = (h - mu) * r;
      v[k] = act_norm ? n : vct::activate(n, act);
    }
    store_vec<V>(o + i, v);
  }
}

long long chunks_of(long long hw) { return (hw + kChunk - 1) / kChunk; }

template <typename T, int V>
cudaError_t launch(const void* x, void* y, float* partial, long long planes,
                   long long hw, int act, int act_norm, float eps,
                   cudaStream_t stream) {
  const int chunks = (int)chunks_of(hw);
  const unsigned blocks = (unsigned)(planes * chunks);
  const T* xt = static_cast<const T*>(x);
  stats_kernel<T, V><<<blocks, kThreads, 0, stream>>>(xt, partial, hw, chunks,
                                                      act, act_norm);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  apply_kernel<T, V><<<blocks, kThreads, 0, stream>>>(
      xt, partial, static_cast<T*>(y), hw, chunks, act, act_norm, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, void* y, float* partial, long long planes,
                     long long hw, int act, int act_norm, float eps,
                     cudaStream_t stream) {
  constexpr int kVec = 16 / (int)sizeof(T);
  const bool aligned = reinterpret_cast<std::uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<std::uintptr_t>(y) % 16 == 0;
  if (aligned && hw % kVec == 0)
    return launch<T, kVec>(x, y, partial, planes, hw, act, act_norm, eps,
                           stream);
  return launch<T, 1>(x, y, partial, planes, hw, act, act_norm, eps, stream);
}

}  // namespace

// Floats of scratch the launch needs for `planes` planes of `hw` elements (two
// per chunk), or -1 when the grid would not fit.
extern "C" long long vct_in_act_tiled_scratch_floats(long long planes,
                                                     long long hw) {
  if (planes <= 0 || hw <= 0) return -1;
  const long long blocks = planes * chunks_of(hw);
  if (planes > INT_MAX || blocks > INT_MAX) return -1;
  return 2 * blocks;
}

// x, y: contiguous (planes, hw) views of NCHW tensors (planes = N*C, hw = H*W).
// scratch: vct_in_act_tiled_scratch_floats(planes, hw) floats of f32.
// dtype: vct::kFloat32 or vct::kBFloat16. act: vct::kRelu..vct::kIdentity.
// act_norm: 1 = activation then norm, 0 = norm then activation.
// Returns the cudaError_t of the launches (0 = success).
extern "C" int vct_in_act_tiled(const void* x, void* y, void* scratch,
                                long long planes, long long hw, int dtype,
                                int act, int act_norm, float eps,
                                void* stream) {
  if (vct_in_act_tiled_scratch_floats(planes, hw) < 0 || act < 0 ||
      act > vct::kIdentity)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* partial = static_cast<float*>(scratch);
  if (dtype == vct::kFloat32)
    return (int)dispatch<float>(x, y, partial, planes, hw, act, act_norm, eps,
                                s);
  if (dtype == vct::kBFloat16)
    return (int)dispatch<__nv_bfloat16>(x, y, partial, planes, hw, act,
                                        act_norm, eps, s);
  return (int)cudaErrorInvalidValue;
}
