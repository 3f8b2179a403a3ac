// Fused InstanceNorm + activation over the (n, c) planes of an NCHW tensor,
// one read of each plane, SINGLE-PASS variance, for planes of any size.
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
// What bounds it: device-memory bytes (x read once, y written once, a handful
// of flops per element); at the training path's big planes (256x256 and
// 128x128) a call moves tens to hundreds of MB.
//
// Design: the TPU kernel walks the HW tiles of a sample in order and carries
// (s, ss) in its output block from one grid step to the next. Here the plane
// itself stays on chip instead (in_plane.cuh with Var = SinglePass): read
// once into registers, (s, ss) reduced in one exchange, written once, one
// launch, no scratch. The path's 16x16 and 32x32 planes take regime (a)
// (a warp per plane), 64x64 and 128x128 regime (b) (a CTA per plane), 256x256
// regime (c): a cluster of 8 CTAs whose (s, ss) cross through distributed
// shared memory in rank order. Regimes and thresholds: in_plane.cuh.

#include "in_plane.cuh"

// x, y: contiguous (planes, hw) views of NCHW tensors (planes = N*C, hw = H*W).
// dtype: vct::kFloat32 or vct::kBFloat16. act: vct::kRelu..vct::kIdentity.
// act_norm: 1 = activation then norm, 0 = norm then activation.
// Returns the cudaError_t of the launch (0 = success).
extern "C" int vct_in_act_tiled(const void* x, void* y, long long planes,
                                long long hw, int dtype, int act, int act_norm,
                                float eps, void* stream) {
  return vct::in_plane<vct::SinglePass>(x, y, planes, hw, dtype, act,
                                        act_norm, eps, stream);
}
