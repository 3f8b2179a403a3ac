// Fused InstanceNorm + activation over the (n, c) planes of an NCHW tensor,
// one read of each plane, CENTERED variance.
//
// Replaces vae_cyclegan_tpu/ops/instance_norm.py::_pallas_in_act (kernel body
// _in_act_kernel): per plane, the f32 mean and then the centered biased
// variance over H*W, y = (h - mean) * rsqrt(var + eps) with h = act(x) for
// act_norm (else x, the activation after the norm), one rounding to the
// input type.
//
// What bounds it: device-memory bytes (x read once, y written once). Its path
// planes are small (16x16 and 32x32 under "auto": 256 and 1024 elements), so
// a call moves a few MB and the latency of one load, two reductions and one
// store sets its time.
//
// Design: in_plane.cuh with Var = Centered. Each plane is read once into
// registers; the mean is reduced first (warp shuffles, then the warps and,
// for planes over 32 KB, the cluster's ranks in order), then the centered
// sum of squares of the values still on chip, and the plane is written once,
// in one launch. The path's planes take regime (a), one warp per plane, with
// no shared memory and no barrier. Regimes and thresholds: in_plane.cuh.

#include "in_plane.cuh"

// x, y: contiguous (planes, hw) views of NCHW tensors (planes = N*C, hw = H*W).
// dtype: vct::kFloat32 or vct::kBFloat16. act: kRelu..kSigmoid, 4 = identity.
// act_norm: 1 = activation then norm, 0 = norm then activation.
// Returns the cudaError_t of the launch (0 = success).
extern "C" int vct_in_act(const void* x, void* y, long long planes,
                          long long hw, int dtype, int act, int act_norm,
                          float eps, void* stream) {
  return vct::in_plane<vct::Centered>(x, y, planes, hw, dtype, act, act_norm,
                                      eps, stream);
}

// The plan both IN kernels take for planes of `hw` elements of `dtype`
// (vct::kFloat32 or vct::kBFloat16), with 16-byte loads when `vector_ok`:
// out = {regime (0 warp, 1 block, 2 cluster, 3 stream), elements per load,
// elements a thread holds, CTAs per plane}. Returns 0, or -1 for a bad dtype.
extern "C" int vct_in_plane_plan(long long hw, int dtype, int vector_ok,
                                 int* out) {
  if (hw <= 0 || (dtype != vct::kFloat32 && dtype != vct::kBFloat16))
    return -1;
  const vct::PlanePlan p =
      vct::plan_plane(hw, dtype == vct::kFloat32 ? 4 : 2, vector_ok != 0);
  out[0] = p.regime;
  out[1] = p.vec;
  out[2] = p.elems;
  out[3] = p.cluster;
  return 0;
}
