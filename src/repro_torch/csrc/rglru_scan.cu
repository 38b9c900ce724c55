// RG-LRU scan for Hopper (sm_90a): the whole function in one launch.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rglru_scan.py
// (`rglru_pallas`, body `_kernel`) together with the elementwise work its
// JAX wrapper does before the pallas_call.  From x, r, i (b, s, w) in their
// own type (fp32 or bf16) and lam (w,) in fp32 it forms, as the JAX wrapper
// does,
//   log_a = -8 softplus(lam) r,  a = exp(log_a),
//   b     = sqrt(max(1 - exp(2 log_a), 1e-12)) (i x),
// and runs h_t = a_t h_{t-1} + b_t over time from h = 0 with the carry in
// fp32; h is written once, in x's type.  softplus is JAX's form,
// logaddexp(lam, 0) = max(lam, 0) + log1p(exp(-|lam|)), taken once per
// channel.  i x is rounded to x's type before it is widened, as JAX forms
// it in bf16 (the product of two bf16 values is exact in fp32, so rounding
// it once gives the bf16 product).  expf, log1pf and sqrtf are the accurate
// ones: where a is close to 1, 1 - exp(2 log_a) cancels, so this file must
// not be built with --use_fast_math.
//
// What bounds it on an H100 SXM.  At the RecurrentGemma-9B prefill (b 4,
// s 512, w 4096, fp32) it must read x, r, i and write h, 4 x 33.5 MB: 0.040
// ms at 3.35 TB/s (0.020 ms in bf16).  Its ~12 flops an element (two exp,
// one sqrt, products) are a third of that time on the CUDA cores, so it is
// bound by bytes, and the arithmetic has to hide under the loads.
//
// Design: a time-split scan.  Every (batch, channel) is an independent
// recurrence, which one thread walking all s steps would leave with too
// little parallel work (b w = 16,384 threads), so time is split too.  A
// block is 32 lanes x T = 16 rows, one warp a row.  Lane l holds V
// neighbouring channels (V = 1 in fp32, 2 in bf16 through bf16x2 words), so
// a warp reads and writes one 128-byte row segment per step.  Row k owns L
// consecutive steps of a super-chunk of T L steps (fp32 L = 8, bf16 L = 4:
// 8 values a thread either way):
//   1. it forms a and b of its L steps from raw x, r, i already in
//      registers and keeps them there; then it issues the next
//      super-chunk's loads (3 L independent words), which fly while this
//      one is scanned and stored;
//   2. it scans its steps from h = 0: the row's (A = prod a, H = local h);
//   3. the (A, H) pairs go through shared memory, and warp k scans whole
//      columns across the T rows, one lane a row, with log2(T) shuffle
//      steps; with the column's carry into the super-chunk that gives each
//      row its carry-in (written back to shared memory) and the carry out,
//      which the column's last lane keeps in a register for the next
//      super-chunk;
//   4. each row walks its L steps again from its carry-in and stores h.
// A loop over super-chunks takes any s.  Steps past s and channels past w
// load zeros, which give a = 1 and b = 0, the identity of the combine; they
// store nothing.  Two barriers a super-chunk.  The association order
// differs from the serial walk (products of a grouped by row and by the
// scan's tree), within the tolerances the Pallas kernel is held to.
//
// At the main shape: 512 threads a block, fp32 128 steps a super-chunk, 32
// channels a block, 512 blocks; bf16 64 steps, 64 channels, 256 blocks.
// At most 64 registers a thread, so two blocks, 32 warps, fit an SM.  Of
// the variants timed on an H100 (256 to 1024 threads a block, 2 to 16 steps
// a thread, with and without the prefetch), this one was the fastest that
// does not spill.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o librglru_scan.so rglru_scan.cu

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int ROWS = 16;  // T: chunk rows a block, one warp each
constexpr float GATE_C = 8.0f;

// Element access of one type: V channels a lane.  A step's values are
// loaded raw (one Raw word) and widened to floats when they are used.  n is
// the number of the lane's channels that exist (0 for a step past s); the
// missing ones read 0 and are not stored.
template <typename E, bool PAIRED>
struct IO;

template <bool PAIRED>
struct IO<float, PAIRED> {
  using Raw = float;
  static constexpr int V = 1, L = 8;
  __device__ static Raw load(const float* p, int n) {
    return n > 0 ? __ldg(p) : 0.f;
  }
  __device__ static void widen(Raw raw, float (&v)[1]) { v[0] = raw; }
  __device__ static void store(float* p, int n, const float (&h)[1]) {
    if (n > 0) *p = h[0];
  }
  __device__ static float round(float x) { return x; }
};

// PAIRED: w even and the rows 4-byte aligned, so a lane's two channels are
// one bf16x2 word, and n is 0 or 2.
template <bool PAIRED>
struct IO<__nv_bfloat16, PAIRED> {
  using Raw = __nv_bfloat162;
  static constexpr int V = 2, L = 4;
  __device__ static Raw load(const __nv_bfloat16* p, int n) {
    const __nv_bfloat16 zero = __ushort_as_bfloat16(0);
    if (PAIRED)
      return n > 0 ? __ldg(reinterpret_cast<const __nv_bfloat162*>(p))
                   : __halves2bfloat162(zero, zero);
    return __halves2bfloat162(n > 0 ? __ldg(p) : zero,
                              n > 1 ? __ldg(p + 1) : zero);
  }
  __device__ static void widen(Raw raw, float (&v)[2]) {
    const float2 f = __bfloat1622float2(raw);
    v[0] = f.x;
    v[1] = f.y;
  }
  __device__ static void store(__nv_bfloat16* p, int n, const float (&h)[2]) {
    if (PAIRED) {
      if (n > 0)
        *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(h[0],
                                                                      h[1]);
    } else {
      if (n > 0) p[0] = __float2bfloat16(h[0]);
      if (n > 1) p[1] = __float2bfloat16(h[1]);
    }
  }
  __device__ static float round(float x) {
    return __bfloat162float(__float2bfloat16(x));
  }
};

__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}

template <typename E, bool PAIRED>
__global__ void __launch_bounds__(32 * ROWS, 2)
    rglru_scan_kernel(const E* __restrict__ x, const E* __restrict__ r,
                      const E* __restrict__ i, const float* __restrict__ lam,
                      E* __restrict__ y, int s, int w) {
  using io = IO<E, PAIRED>;
  constexpr int V = io::V, L = io::L;
  constexpr int SEGS = 32 / ROWS;          // columns a warp scans at once
  constexpr int PITCH = 32 * V + SEGS;     // so the scan's reads hit
                                           // distinct banks
  constexpr int STEPS = ROWS * L;          // steps a super-chunk
  static_assert(32 % ROWS == 0 && ROWS >= 2, "ROWS divides a warp");
  // (A, H) of each (row, column); the scan across rows overwrites H with
  // the row's carry-in
  __shared__ float sA[ROWS * PITCH], sH[ROWS * PITCH];

  const int lane = threadIdx.x, row = threadIdx.y;
  const int ch = (blockIdx.x * 32 + lane) * V;
  const int nch = max(0, min(V, w - ch));
  const int64_t base = int64_t(blockIdx.y) * s * w + ch;
  // in the scan across rows this lane is row j of a column of segment seg
  const int j = lane % ROWS, seg = lane / ROWS;

  float c[V], carry[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    c[v] = v < nch ? -GATE_C * softplus(lam[ch + v]) : 0.f;
    carry[v] = 0.f;
  }

  typename io::Raw xr[L], rr[L], ir[L];
  auto load = [&](int t0) {
#pragma unroll
    for (int u = 0; u < L; ++u) {
      const int t = t0 + row * L + u;
      const int n = t < s ? nch : 0;
      const int64_t off = base + int64_t(t) * w;
      xr[u] = io::load(x + off, n);
      rr[u] = io::load(r + off, n);
      ir[u] = io::load(i + off, n);
    }
  };

  load(0);
  for (int t0 = 0; t0 < s; t0 += STEPS) {
    // 1. a and b of this row's L steps, in registers
    float a[L][V], b[L][V];
#pragma unroll
    for (int u = 0; u < L; ++u) {
      float xv[V], rv[V], iv[V];
      io::widen(xr[u], xv);
      io::widen(rr[u], rv);
      io::widen(ir[u], iv);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const float log_a = c[v] * rv[v];
        a[u][v] = expf(log_a);
        b[u][v] = sqrtf(fmaxf(1.f - expf(2.f * log_a), 1e-12f)) *
                  io::round(iv[v] * xv[v]);
      }
    }
    // the next super-chunk's loads fly while this one is scanned
    if (t0 + STEPS < s) load(t0 + STEPS);

    // 2. the row's own scan from h = 0
#pragma unroll
    for (int v = 0; v < V; ++v) {
      float A = 1.f, H = 0.f;
#pragma unroll
      for (int u = 0; u < L; ++u) {
        H = fmaf(a[u][v], H, b[u][v]);
        A *= a[u][v];
      }
      sA[row * PITCH + v * 32 + lane] = A;
      sH[row * PITCH + v * 32 + lane] = H;
    }
    __syncthreads();

    // 3. across rows: warp `row` scans columns row * SEGS + seg (+ 32 p),
    // one lane a row, by shuffles; a column's carry stays with its last
    // lane from one super-chunk to the next
#pragma unroll
    for (int p = 0; p < V; ++p) {
      const int at = j * PITCH + p * 32 + row * SEGS + seg;
      float A = sA[at], H = sH[at];
#pragma unroll
      for (int d = 1; d < ROWS; d *= 2) {
        const float Ap = __shfl_up_sync(~0u, A, d, ROWS);
        const float Hp = __shfl_up_sync(~0u, H, d, ROWS);
        if (j >= d) {
          H = fmaf(A, Hp, H);
          A *= Ap;
        }
      }
      const float C = __shfl_sync(~0u, carry[p], ROWS - 1, ROWS);
      float Ae = __shfl_up_sync(~0u, A, 1, ROWS);
      float He = __shfl_up_sync(~0u, H, 1, ROWS);
      if (j == 0) {
        Ae = 1.f;
        He = 0.f;
      }
      sH[at] = fmaf(Ae, C, He);
      carry[p] = fmaf(A, C, H);
    }
    __syncthreads();

    // 4. the true h of each step from the row's carry-in
    float h[V];
#pragma unroll
    for (int v = 0; v < V; ++v) h[v] = sH[row * PITCH + v * 32 + lane];
    const int tk = t0 + row * L;
#pragma unroll
    for (int u = 0; u < L; ++u) {
#pragma unroll
      for (int v = 0; v < V; ++v) h[v] = fmaf(a[u][v], h[v], b[u][v]);
      io::store(y + base + int64_t(tk + u) * w, tk + u < s ? nch : 0, h);
    }
  }
}

template <typename E, bool PAIRED>
cudaError_t launch(const void* x, const void* r, const void* i,
                   const float* lam, void* y, int batch, int s, int w,
                   cudaStream_t stream) {
  using io = IO<E, PAIRED>;
  const int ct = 32 * io::V;  // channels a block
  const dim3 grid((w + ct - 1) / ct, batch), block(32, ROWS);
  rglru_scan_kernel<E, PAIRED><<<grid, block, 0, stream>>>(
      static_cast<const E*>(x), static_cast<const E*>(r),
      static_cast<const E*>(i), lam, static_cast<E*>(y), s, w);
  return cudaGetLastError();
}

}  // namespace

// x, r, i, y: contiguous (batch, s, w) of one type, 0 = float32,
// 1 = bfloat16; lam: (w,) float32.  Returns a cudaError_t code; 0 means the
// launch was accepted.
extern "C" int rglru_scan_fwd(const void* x, const void* r, const void* i,
                              const float* lam, void* y, int batch, int s,
                              int w, int dtype, void* stream) {
  if (batch <= 0 || batch > 65535 || s <= 0 || w <= 0)
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return int(launch<float, false>(x, r, i, lam, y, batch, s, w, st));
  if (dtype == 1) {
    const uintptr_t addr = reinterpret_cast<uintptr_t>(x) |
                           reinterpret_cast<uintptr_t>(r) |
                           reinterpret_cast<uintptr_t>(i) |
                           reinterpret_cast<uintptr_t>(y);
    if (w % 2 == 0 && addr % 4 == 0)
      return int(
          launch<__nv_bfloat16, true>(x, r, i, lam, y, batch, s, w, st));
    return int(launch<__nv_bfloat16, false>(x, r, i, lam, y, batch, s, w, st));
  }
  return int(cudaErrorInvalidValue);
}

extern "C" const char* rglru_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
