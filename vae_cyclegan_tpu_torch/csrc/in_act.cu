// Fused InstanceNorm + activation over the (n, c) planes of an NCHW tensor.
//
// Replaces vae_cyclegan_tpu/ops/instance_norm.py::_pallas_in_act (kernel body
// _in_act_kernel): per plane, the f32 mean and then the CENTERED biased
// variance over H*W, y = (x - mean) * rsqrt(var + eps), with the activation
// before the norm (act_norm) or after it (norm_act); output in the input type.
//
// What bounds it: device-memory bytes. Each element is read once and written
// once and costs a handful of flops. On the serving path the planes are 16x16
// (256 elements) and a call moves a few MB, so launch latency matters as much.
//
// Design: one block per plane, the TPU kernel's grid step per sample split
// into one independent block per channel (Hopper has no sequential grid).
// A plane of at most kResidentFloats (12280) elements is read from device memory once
// into shared memory as f32 (activation already applied for act_norm), then
// reduced twice on chip (mean, then centered variance) and written once. A
// larger plane loops over device memory three times (mean, variance, write):
// slower, but the same centered arithmetic. Reductions are a fixed-order
// per-thread sum, a warp butterfly and a serial sum over the warps, so results
// are deterministic from run to run.

#include <climits>

#include "common.cuh"

namespace {

constexpr int kMaxThreads = 256;
// The plane plus the static per-warp `scratch` of block_sum must fit the
// 48 KB of shared memory a block gets without opting in to more.
constexpr long long kResidentFloats = 12288 - kMaxThreads / 32;

using vct::activate;
using vct::block_sum;

template <typename T, bool kResident>
__global__ void __launch_bounds__(kMaxThreads)
    in_act_kernel(const T* __restrict__ x, T* __restrict__ y, long long hw,
                  int act, int act_norm, float eps) {
  extern __shared__ float plane[];  // hw floats when kResident
  __shared__ float scratch[kMaxThreads / 32];
  const long long base = (long long)blockIdx.x * hw;
  const float count = (float)hw;

  float s = 0.f;
  for (long long i = threadIdx.x; i < hw; i += blockDim.x) {
    float v = vct::load_f(x, base + i);
    if (act_norm) v = activate(v, act);
    if (kResident) plane[i] = v;  // each thread re-reads only its own slots
    s += v;
  }
  const float mu = block_sum(s, scratch) / count;

  float ss = 0.f;
  for (long long i = threadIdx.x; i < hw; i += blockDim.x) {
    float v;
    if (kResident) {
      v = plane[i];
    } else {
      v = vct::load_f(x, base + i);
      if (act_norm) v = activate(v, act);
    }
    const float d = v - mu;
    ss += d * d;
  }
  const float r = rsqrtf(block_sum(ss, scratch) / count + eps);

  for (long long i = threadIdx.x; i < hw; i += blockDim.x) {
    float v;
    if (kResident) {
      v = plane[i];
    } else {
      v = vct::load_f(x, base + i);
      if (act_norm) v = activate(v, act);
    }
    float o = (v - mu) * r;
    if (!act_norm) o = activate(o, act);
    vct::store_f(y, base + i, o);
  }
}

template <typename T>
cudaError_t launch(const void* x, void* y, long long planes, long long hw,
                   int act, int act_norm, float eps, cudaStream_t stream) {
  const int threads =
      hw >= kMaxThreads ? kMaxThreads : (int)((hw + 31) / 32 * 32);
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  if (hw <= kResidentFloats) {
    in_act_kernel<T, true><<<(unsigned)planes, threads, hw * sizeof(float),
                             stream>>>(xt, yt, hw, act, act_norm, eps);
  } else {
    in_act_kernel<T, false><<<(unsigned)planes, threads, 0, stream>>>(
        xt, yt, hw, act, act_norm, eps);
  }
  return cudaGetLastError();
}

}  // namespace

// x, y: contiguous (planes, hw) views of NCHW tensors (planes = N*C, hw = H*W).
// dtype: vct::kFloat32 or vct::kBFloat16. act: kRelu..kSigmoid, 4 = identity.
// act_norm: 1 = activation then norm, 0 = norm then activation.
// Returns the cudaError_t of the launch (0 = success).
extern "C" int vct_in_act(const void* x, void* y, long long planes,
                          long long hw, int dtype, int act, int act_norm,
                          float eps, void* stream) {
  if (planes <= 0 || planes > INT_MAX || hw <= 0 || act < 0 || act > 4)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == vct::kFloat32)
    return (int)launch<float>(x, y, planes, hw, act, act_norm, eps, s);
  if (dtype == vct::kBFloat16)
    return (int)launch<__nv_bfloat16>(x, y, planes, hw, act, act_norm, eps, s);
  return (int)cudaErrorInvalidValue;
}
