// Device helpers shared by the port's kernels: an fp32 store in either
// element type, 16-byte asynchronous copies (cp.async), ldmatrix, and the
// bf16 tensor-core product mma.sync m16n8k16 with fp32 accumulation (all
// sm_80+ instructions that Hopper keeps); and the one-time setting of a
// kernel's shared-memory attributes.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace hopper {

__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copy 16 bytes from global to shared memory without passing through
// registers.  With src_bytes == 0 nothing is read and the 16 bytes are
// zeroed (the ragged edge of a tile).  Both addresses are 16-byte aligned.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid = true) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N of this thread's committed groups are in flight.
// Other threads' copies are visible only after a __syncthreads().
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 b16 matrices from shared memory; lanes 8i..8i+7 give the row
// addresses of matrix i, and lane l receives row l/4, columns 2(l%4) and
// 2(l%4)+1 of each matrix (with .trans: rows 2(l%4), 2(l%4)+1 of column
// l/4).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// d += a b for a 16x16 bf16 tile a (row major) and a 16x8 bf16 tile b
// (column major), in fp32.  With g = lane / 4 and c = lane % 4: a holds
// (g, 2c..2c+1), (g+8, 2c..), (g, 2c+8..), (g+8, 2c+8..); b holds rows
// 2c..2c+1 and 2c+8..2c+9 of column g; d holds (g, 2c..2c+1) and
// (g+8, 2c..2c+1).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to bf16 in one register, lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Allow `kernel` up to `smem` bytes of dynamic shared memory and prefer the
// largest shared-memory carveout.  The attributes are set once per `ready`
// flag (one flag per kernel), so later launches, and launches under CUDA
// graph capture, make no further runtime calls before the launch.
template <typename K>
cudaError_t set_smem_once(K kernel, size_t smem, bool& ready) {
  if (ready) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               int(cudaSharedmemCarveoutMaxShared));
  ready = err == cudaSuccess;
  return err;
}

}  // namespace hopper
