// The asynchronous copies and matrix loads the tensor-core kernels share
// (starved_dw.cu, dot_probe.cu and the NHWC conv core nhwc_conv.cuh):
// cp.async of 16 bytes from device to shared memory in commit groups,
// ldmatrix of four 8 x 8 bf16 matrices, and stmatrix of four, transposed.
#pragma once

#include <stdint.h>

#include <cuda_runtime.h>

namespace vct {
namespace ptx {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)),
               "l"(src)
               : "memory");
}
// the first `bytes` (0..16) of the 16 at src, zeros after them
__device__ __forceinline__ void cp_async16_part(void* dst, const void* src,
                                                int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
// 16 bytes when `full`, else 16 zero bytes (src is not read)
__device__ __forceinline__ void cp_async16_or_zero(void* dst, const void* src,
                                                   bool full) {
  cp_async16_part(dst, src, full ? 16 : 0);
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most `N` of this thread's commit groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() { cp_async_wait<0>(); }

// the four 8 x 8 bf16 matrices of an m16n8k16 A fragment (or two B
// fragments); lane l gives the address of one 16-byte matrix row: row l % 8
// of matrix l / 8
__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// the four 8 x 8 bf16 matrices of r (r[i]: this lane's pair of matrix i, row
// lane / 4, columns 2 (lane % 4) and + 1: an m16n8 C fragment's rows) stored
// transposed: lane l gives the address of stored row l % 8 of matrix l / 8,
// which receives column l % 8 of it as 16 bytes
__device__ __forceinline__ void stmatrix_x4_trans(unsigned addr,
                                                  const uint32_t r[4]) {
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, %4};\n"
      ::"r"(addr), "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
      : "memory");
}

}  // namespace ptx
}  // namespace vct
