// Shared helpers of the hand-written kernels: f32 loads and stores of the two
// element types the kernels take (float and bfloat16), the activations of the
// fused InstanceNorm kernels and a deterministic block sum. Arithmetic is
// always f32; a bf16 store rounds to nearest even, as torch's
// `.to(torch.bfloat16)`.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace vct {

// Element type codes shared with the Python wrappers.
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

__device__ __forceinline__ float load_f(const float* p, long long i) { return p[i]; }

__device__ __forceinline__ float load_f(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(p[i]);
}

__device__ __forceinline__ void store_f(float* p, long long i, float v) { p[i] = v; }

__device__ __forceinline__ void store_f(__nv_bfloat16* p, long long i, float v) {
  p[i] = __float2bfloat16(v);
}

// Activation codes shared with the Python wrappers (ops/instance_norm.py);
// 4 is the identity.
constexpr int kRelu = 0;
constexpr int kLeakyRelu = 1;
constexpr int kTanh = 2;
constexpr int kSigmoid = 3;
constexpr int kIdentity = 4;

__device__ __forceinline__ float activate(float x, int act) {
  switch (act) {
    case kRelu:
      return x < 0.f ? 0.f : x;
    case kLeakyRelu:
      return x >= 0.f ? x : 0.2f * x;
    case kTanh:
      return tanhf(x);
    case kSigmoid:
      return 1.f / (1.f + expf(-x));
    default:  // identity
      return x;
  }
}

// Sum over the block; every thread receives the total. blockDim.x is a
// multiple of 32. `scratch` holds one partial per warp. The order is fixed (a
// warp butterfly, then a serial sum over the warps), so the result repeats bit
// for bit from run to run.
__device__ __forceinline__ float block_sum(float v, float* scratch) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  __syncthreads();  // the previous call's readers are done with scratch
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float total = 0.f;
  for (int i = 0; i < (int)(blockDim.x >> 5); ++i) total += scratch[i];
  return total;
}

}  // namespace vct
