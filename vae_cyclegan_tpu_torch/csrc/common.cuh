// Shared helpers of the hand-written kernels: f32 loads and stores of the two
// element types the kernels take (float and bfloat16). Arithmetic is always
// f32; a bf16 store rounds to nearest even, as torch's `.to(torch.bfloat16)`.
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

}  // namespace vct
