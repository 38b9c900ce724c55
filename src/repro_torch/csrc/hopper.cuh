// Device helpers shared by the port's kernels.
//
// sm_80+ instructions that Hopper keeps: an fp32 store in either element
// type, shared-memory loads and stores at 32-bit addresses, 16-byte
// asynchronous copies (cp.async), ldmatrix, and 2^x on the MUFU unit; and,
// on the host, the one-time setting of a kernel's shared-memory attributes
// and the encoding of bf16 TMA tensor maps.
//
// sm_90a only (the `a` target: wgmma exists nowhere else), used by the bf16
// attention kernel and the bf16 SSD scan: mbarriers (init, arrive, arrive
// with an expected transaction count, parity wait), TMA tile loads
// (cp.async.bulk.tensor, 4-d, completed on an mbarrier), tensor-map
// prefetch and the proxy fence between generic and async accesses to
// shared memory, setmaxnreg, and the warpgroup products wgmma.mma_async
// m64n64k16, m64n128k16 and m64n256k16, A from registers (or, at m64n64k16,
// from shared memory) and B from shared memory K-major or N-major, with
// their fence / commit / wait and 128-byte-swizzle matrix descriptors.

#pragma once

#include <cuda.h>
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

// 4 and 16 bytes at a shared-memory address (smem_addr): 32-bit addresses
// where a generic pointer would take 64 bits a register pair.
__device__ __forceinline__ void st_shared_b32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}
__device__ __forceinline__ uint4 ld_shared_v4(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr)
               : "memory");
  return v;
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

// 2^x on the MUFU.EX2 unit (about 2 ulp), denormal results flushed to 0:
// softmax weights, where those are 0 anyway.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two floats rounded to bf16 in one register, lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// cuTensorMapEncodeTiled (libcuda), looked up at run time through the
// runtime's entry-point query, so that the library links only cudart.
using EncodeTiled = decltype(&cuTensorMapEncodeTiled);
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A 4-d bf16 map (width, rows, heads, batch) over `base` with element
// strides ss, sh, sb, boxes of 64 x box_rows in the 128-byte swizzle.  The
// stride of a dim of extent 1 is never used; it is replaced by a natural
// one, since the encoder wants every stride a positive multiple of 16 B.
inline bool encode_bf16_map(CUtensorMap* map, EncodeTiled encode,
                            const void* base, int width, int rows, int heads,
                            int batch, int64_t ss, int64_t sh, int64_t sb,
                            int box_rows) {
  cuuint64_t st[3] = {cuuint64_t(2 * ss), cuuint64_t(2 * sh),
                      cuuint64_t(2 * sb)};
  if (rows == 1) st[0] = (2 * width + 15) / 16 * 16;
  if (heads == 1) st[1] = st[0] * rows;
  if (batch == 1)
    st[2] = st[1] * heads > st[0] * rows ? st[1] * heads : st[0] * rows;
  const cuuint64_t dims[4] = {cuuint64_t(width), cuuint64_t(rows),
                              cuuint64_t(heads), cuuint64_t(batch)};
  const cuuint32_t box[4] = {64, cuuint32_t(box_rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), dims, st, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
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

// ------------------------------------------------------- sm_90a only ---
#if defined(__CUDA_ARCH__) && !defined(__CUDA_ARCH_FEAT_SM90_ALL)
#error "hopper.cuh: build for sm_90a (-gencode arch=compute_90a,code=sm_90a)"
#endif

// mbarrier in shared memory: `count` arrivals complete a phase.  Call from
// one thread, then fence_mbarrier_init() and a block barrier.
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void fence_mbarrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}
// One arrival that also expects `bytes` more of asynchronous transactions
// (the TMA loads that complete on this barrier) in the current phase.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}
// Wait until the phase of parity `parity` has completed (a fresh barrier is
// in phase 0, so a wait on parity 1 returns at once).  After 2^30 failed
// tries (seconds) it traps: a broken protocol fails the launch rather than
// hang the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  for (uint32_t tries = 0;; ++tries) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (tries == (1u << 30)) __trap();
  }
}

// Bring a tensor map (in parameter, constant or global memory) into the
// descriptor cache ahead of its first TMA load.
__device__ __forceinline__ void prefetch_tensormap(const void* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

// TMA: the box at coordinates (c0 innermost .. c3) of the 4-d tensor map
// `map` (a CUtensorMap in parameter, constant or global memory) into
// shared memory at `dst`, completing `bytes` of the transaction count of
// `bar`.  Elements outside the tensor are zero-filled and still counted.
__device__ __forceinline__ void tma_load_4d(void* dst, const void* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma matrix descriptor of a tile in the 128-byte swizzle layout (what a
// TMA load with CU_TENSOR_MAP_SWIZZLE_128B writes: 128-byte rows, 16-byte
// chunks XOR-ed with the row's low 3 bits, 1024-byte aligned atoms of 8
// rows).  lbo / sbo in bytes: for a K-major operand sbo is the stride of
// 8-row groups and lbo is unused; for an MN-major one lbo is the stride of
// 64-element column blocks and sbo that of 8-row (K) groups.
__device__ __forceinline__ uint64_t wgmma_desc_sw128(const void* tile,
                                                     uint32_t lbo,
                                                     uint32_t sbo) {
  return uint64_t((smem_addr(tile) & 0x3FFFF) >> 4) |
         (uint64_t(lbo >> 4) << 16) | (uint64_t(sbo >> 4) << 32) |
         (uint64_t(1) << 62);
}

// Hand registers between warpgroups: every thread of the warpgroup runs it
// at once, in code that never rejoins the other warpgroups' (a kernel-long
// if / else), and the block's total must fit the register file.
template <uint32_t N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <uint32_t N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// Order this thread's generic-proxy accesses to shared memory before later
// async-proxy ones (TMA loads into the same bytes).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Pin accumulator registers at this point of the program: reads after a
// wgmma_wait() and writes before a wgmma_fence() stay on their side.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define HOPPER_D8(i)                                                   \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),          \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 x 64, fp32; d = 0 first when !accumulate) += a b^T: a (64 x 16
// bf16) in registers, the m16n8k16 A fragment of the thread's warp's 16
// rows (what ldmatrix_x4 gives), b (64 x 16 bf16) K-major in shared
// memory.  Thread t of the warpgroup holds rows 16 (t / 32) + (t % 32) / 4
// + 8 ((i / 2) % 2), columns 8 (i / 4) + 2 (t % 4) + i % 2 of d[i]: the
// mma.sync m16n8 layout, repeated over the 8-column tiles.
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32],
                                                   const uint32_t (&a)[4],
                                                   uint64_t b,
                                                   int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : HOPPER_D8(0), HOPPER_D8(8), HOPPER_D8(16), HOPPER_D8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// d (64 x 128, fp32) += a (64 x 16 bf16 in registers, the m16n8k16 A
// fragment of the thread's warp's 16 rows) b, with b (16 x 128 bf16) in
// shared memory N-major (transposed: the 128 columns contiguous).
__device__ __forceinline__ void wgmma_m64n128k16_rs_tn(float (&d)[64],
                                                       const uint32_t (&a)[4],
                                                       uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : HOPPER_D8(0), HOPPER_D8(8), HOPPER_D8(16), HOPPER_D8(24),
        HOPPER_D8(32), HOPPER_D8(40), HOPPER_D8(48), HOPPER_D8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 64, fp32) += a (64 x 16 bf16 in registers, as in
// wgmma_m64n64k16_rs) b, with b (16 x 64 bf16) in shared memory N-major
// (its 64 columns contiguous: one 128-byte row of the swizzle).
__device__ __forceinline__ void wgmma_m64n64k16_rs_tn(float (&d)[32],
                                                      const uint32_t (&a)[4],
                                                      uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : HOPPER_D8(0), HOPPER_D8(8), HOPPER_D8(16), HOPPER_D8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 128, fp32; d = 0 first when !accumulate) += a b^T: a (64 x 16
// bf16) in registers as above, b (128 x 16 bf16) K-major in shared memory.
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64],
                                                    const uint32_t (&a)[4],
                                                    uint64_t b,
                                                    int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : HOPPER_D8(0), HOPPER_D8(8), HOPPER_D8(16), HOPPER_D8(24),
        HOPPER_D8(32), HOPPER_D8(40), HOPPER_D8(48), HOPPER_D8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(accumulate));
}

// d (64 x 64, fp32; d = 0 first when !accumulate) += a b^T with both
// operands in shared memory, K-major: a (64 x 16 bf16) and b (64 x 16 bf16)
// through their descriptors.  d is laid out as in wgmma_m64n64k16_rs.
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t a,
                                                   uint64_t b,
                                                   int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : HOPPER_D8(0), HOPPER_D8(8), HOPPER_D8(16), HOPPER_D8(24)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 256, fp32) += a (64 x 16 bf16 in registers, as in
// wgmma_m64n64k16_rs) b, with b (16 x 256 bf16) in shared memory N-major:
// four 64-column blocks, lbo apart in its descriptor.  Thread t holds
// column 8 (i / 4) + 2 (t % 4) + i % 2 of d[i], rows as there.
__device__ __forceinline__ void wgmma_m64n256k16_rs_tn(float (&d)[128],
                                                       const uint32_t (&a)[4],
                                                       uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : HOPPER_D8(0), HOPPER_D8(8), HOPPER_D8(16), HOPPER_D8(24),
        HOPPER_D8(32), HOPPER_D8(40), HOPPER_D8(48), HOPPER_D8(56),
        HOPPER_D8(64), HOPPER_D8(72), HOPPER_D8(80), HOPPER_D8(88),
        HOPPER_D8(96), HOPPER_D8(104), HOPPER_D8(112), HOPPER_D8(120)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef HOPPER_D8

}  // namespace hopper
