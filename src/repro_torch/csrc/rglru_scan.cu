// RG-LRU linear recurrence for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/rglru_scan.py
// (`rglru_pallas`, body `_kernel`) and computes what it computes: from
// h = 0, h_t = a_t h_{t-1} + b_t over time, the carry in fp32, y_t = h_t in
// the output's type (fp32 or bf16).  The wrapper forms a and b in fp32, as
// the JAX wrapper does: a = exp(-8 softplus(lam) r),
// b = sqrt(max(1 - a^2, 1e-12)) (i x).
//
// Design.  The recurrence couples only time, so every (batch, channel) is
// independent.  One thread owns one (b, channel) and walks t = 0 .. s-1;
// neighbouring threads hold neighbouring channels, so every load and store
// of a warp is one coalesced 128-byte row segment.  The loads do not depend
// on h, so the walk goes U steps at a time: the U values of a and of b are
// loaded first, all in flight at once, and then the U dependent FMAs run.
// Blocks are small (64 threads) so that the few threads there are spread
// over all SMs.  Any s, w and b are taken; the ragged edge of w is masked.
//
// Bound on an H100 SXM.  At the RecurrentGemma-9B prefill (b 4, s 512,
// w 4096) it reads a and b (2 x 33.5 MB fp32) and writes y (33.5 MB): ~100
// MB, ~0.030 ms at 3.35 TB/s.  The 2 b s w flops are negligible, so it is
// bound by bytes.  Only b w = 16,384 threads exist, each with a 512-long
// dependent chain; the loads ahead are what keeps enough bytes in flight.
// A two-pass chunked scan, with more threads, is later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o librglru_scan.so rglru_scan.cu

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int THREADS = 64;
constexpr int U = 16;  // time steps loaded ahead

__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename O>
__global__ void __launch_bounds__(THREADS)
    rglru_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                      O* __restrict__ y, int s, int w) {
  const int ch = blockIdx.x * THREADS + threadIdx.x;
  if (ch >= w) return;
  const int64_t base = int64_t(blockIdx.y) * s * w + ch;
  const float* ap = a + base;
  const float* bp = b + base;
  O* yp = y + base;
  float h = 0.f;
  int t = 0;
  for (; t + U <= s; t += U) {
    float av[U], bv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      av[u] = __ldg(ap + int64_t(t + u) * w);
      bv[u] = __ldg(bp + int64_t(t + u) * w);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      h = fmaf(av[u], h, bv[u]);
      store_f32(yp + int64_t(t + u) * w, h);
    }
  }
  for (; t < s; ++t) {
    h = fmaf(__ldg(ap + int64_t(t) * w), h, __ldg(bp + int64_t(t) * w));
    store_f32(yp + int64_t(t) * w, h);
  }
}

template <typename O>
cudaError_t launch(const float* a, const float* b, void* y, int batch, int s,
                   int w, cudaStream_t stream) {
  const dim3 grid((w + THREADS - 1) / THREADS, batch);
  rglru_scan_kernel<O><<<grid, THREADS, 0, stream>>>(a, b, static_cast<O*>(y),
                                                     s, w);
  return cudaGetLastError();
}

}  // namespace

// a, b: contiguous (batch, s, w) fp32; y: contiguous (batch, s, w).
// dtype of y: 0 = float32, 1 = bfloat16.  Returns a cudaError_t code; 0
// means the launch was accepted.
extern "C" int rglru_scan_fwd(const float* a, const float* b, void* y,
                              int batch, int s, int w, int dtype,
                              void* stream) {
  if (batch <= 0 || batch > 65535 || s <= 0 || w <= 0)
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return int(launch<float>(a, b, y, batch, s, w, st));
  if (dtype == 1) return int(launch<__nv_bfloat16>(a, b, y, batch, s, w, st));
  return int(cudaErrorInvalidValue);
}

extern "C" const char* rglru_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
