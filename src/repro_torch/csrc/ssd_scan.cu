// Mamba2 chunked SSD scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan.py (`ssd_scan`,
// body `_kernel`) and computes what it computes.  The wrapper forms
// la = dt * A in fp32 and xbar = x * dt in x's type; per chunk of Q rows,
// with cum = cumsum(la) and total = cum[Q - 1],
//   y   = (C B^T (.) L) xbar + exp(cum) (.) (C S^T),  L_ij = exp(cum_i - cum_j)
//         for i >= j, else 0
//   S  <- S exp(total) + xbar^T (B (.) exp(total - cum))
// from S = 0, and the final S is the second output.  xbar, B and C are fp32
// or bf16 (one type for the three), y has their type, S is fp32, and every
// product is taken in fp32 on the CUDA cores.
//
// Design.  One block owns one (batch b, head h) pair and walks the chunks
// in order, as the Pallas kernel's sequential grid axis does; the state S
// (P x N fp32, 32 KB at P = 64, N = 128) stays in shared memory for the
// whole walk.  On the TPU a program holds a whole chunk in VMEM; here one
// chunk of B and C at Q = 256, N = 128 would be 2 x 128 KB, more than the
// 227 KB a block may have.  So the chunk is cut into 64-row tiles:
//   1. for each query tile of the chunk, the C tile is staged, and for each
//      key tile at or below the diagonal (tiles above it have L = 0, so
//      skipping them is exact) the B and xbar tiles are staged; the 256
//      threads form a 16 x 16 grid, each thread computes a 4 x 4 block of
//      C B^T, scales it by L, and adds its 4 x (P / 16) block of
//      (scores (.) L) xbar into registers;
//   2. the carried state adds exp(cum_i) (C_i . S_d) to the same registers,
//      and the tile of y is written;
//   3. each thread sums xbar^T (B (.) decay) over the chunk's rows for the
//      elements of S it owns, in registers, key tile by key tile; once every
//      query tile of the chunk has read the old S, S <- S exp(total) + sum.
// exp(cum_i - cum_j) is taken only where i >= j.  There it is <= 1, because
// dt >= 0 and A < 0; the JAX code takes it everywhere and masks afterwards,
// which here would compute inf in the masked half.  cum is the sequential
// prefix sum of la, taken by one thread, in cumsum's order.
//
// Repeated work: C B^T is the same for all heads (B and C have one group),
// and this kernel recomputes it per head.  Sharing it across heads is later
// work.  Only b * h blocks run (128 at the Mamba2-370M prefill, on 132 SMs),
// one per SM.
//
// Bound on an H100 SXM.  At the Mamba2-370M prefill (b 4, s 512, h 32,
// p 64, n 128, chunk 256), counting the per-head work this kernel does,
// ~8.6 GFLOP over ~40 MB: ~0.13 ms at 67 TFLOP/s fp32 against ~0.012 ms at
// 3.35 TB/s, so it is bound by operations.  Shared-memory reads feed the
// FMAs, as in flash_attention.cu; tensor cores are later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libssd_scan.so ssd_scan.cu

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

namespace {

constexpr int T = 64;         // rows per tile (queries and keys)
constexpr int THREADS = 256;  // 16 x 16 thread grid over a tile
constexpr int MAX_N = 128;    // d_state the shared memory is sized for

struct Params {
  const float* la;   // (b, s, h) fp32
  const void* xbar;  // (b, s, h, p)
  const void* B;     // (b, s, n)
  const void* C;     // (b, s, n)
  void* y;           // (b, s, h, p)
  float* state;      // (b, h, p, n) fp32
  int s, h, n, chunk;
};

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <int P>
size_t smem_bytes(int n, int chunk) {
  const int ldn = n + 1;
  return sizeof(float) * (size_t(2) * T * ldn      // C tile, B tile
                          + size_t(T) * (P + 1)    // xbar tile
                          + size_t(T) * (T + 1)    // scores (.) L
                          + size_t(P) * ldn        // the state S
                          + size_t(2) * chunk);    // cum, decay to end
}

// Stage rows [row0, row0 + nrows) of a (rows, width) slab with row stride
// `ld_g` into a T x ld fp32 tile, row r times scale[r] where scale is given;
// rows past nrows are zero.
template <typename E>
__device__ __forceinline__ void stage(float* dst, int ld, const E* src,
                                      int64_t ld_g, int width, int nrows,
                                      const float* scale = nullptr) {
  for (int i = threadIdx.x; i < T * width; i += THREADS) {
    const int r = i / width, c = i % width;
    float v = 0.f;
    if (r < nrows) {
      v = load_f32(src + int64_t(r) * ld_g + c);
      if (scale) v *= scale[r];
    }
    dst[r * ld + c] = v;
  }
}

template <typename E, int P>
__global__ void __launch_bounds__(THREADS) ssd_scan_kernel(const Params p) {
  static_assert(P % 16 == 0, "head dim must be a multiple of 16");
  constexpr int PJ = P / 16;       // output columns per thread
  constexpr int NJ = MAX_N / 16;   // state columns per thread, at most
  constexpr int LDP = P + 1;
  constexpr int LDS = T + 1;
  const int n = p.n, ldn = n + 1, Q = p.chunk;

  extern __shared__ float smem[];
  float* Cs = smem;             // T x ldn
  float* Bs = Cs + T * ldn;     // T x ldn
  float* Xs = Bs + T * ldn;     // T x LDP
  float* Ss = Xs + T * LDP;     // T x LDS
  float* St = Ss + T * LDS;     // P x ldn: the state S[d][n]
  float* cum = St + P * ldn;    // Q
  float* dec = cum + Q;         // Q: exp(total - cum)

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int h = blockIdx.x % p.h, b = blockIdx.x / p.h;
  const int H = p.h;

  const float* la = p.la + int64_t(b) * p.s * H + h;
  const E* xb = static_cast<const E*>(p.xbar) + (int64_t(b) * p.s * H + h) * P;
  const E* Bg = static_cast<const E*>(p.B) + int64_t(b) * p.s * n;
  const E* Cg = static_cast<const E*>(p.C) + int64_t(b) * p.s * n;
  E* yg = static_cast<E*>(p.y) + (int64_t(b) * p.s * H + h) * P;
  const int64_t ldx = int64_t(H) * P;  // row stride of xbar and y

  for (int i = tid; i < P * ldn; i += THREADS) St[i] = 0.f;

  for (int c0 = 0; c0 < p.s; c0 += Q) {
    // cum and the decay to the chunk's end
    for (int t = tid; t < Q; t += THREADS) cum[t] = la[int64_t(c0 + t) * H];
    __syncthreads();
    if (tid == 0) {
      float acc = 0.f;
      for (int t = 0; t < Q; ++t) {
        acc += cum[t];
        cum[t] = acc;
      }
    }
    __syncthreads();
    const float total = cum[Q - 1];
    for (int t = tid; t < Q; t += THREADS) dec[t] = expf(total - cum[t]);

    for (int q0 = 0; q0 < Q; q0 += T) {
      const int rows = min(T, Q - q0);
      __syncthreads();  // the last tile's reads of Cs are done
      stage(Cs, ldn, Cg + int64_t(c0 + q0) * n, n, n, rows);

      float acc[4][PJ];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < PJ; ++j) acc[i][j] = 0.f;

      for (int k0 = 0; k0 <= q0; k0 += T) {
        const int kcols = min(T, Q - k0);
        __syncthreads();  // the last key tile's reads are done
        stage(Bs, ldn, Bg + int64_t(c0 + k0) * n, n, n, kcols);
        stage(Xs, LDP, xb + int64_t(c0 + k0) * ldx, ldx, P, kcols);
        __syncthreads();

        float s[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
        for (int e = 0; e < n; ++e) {
          float a[4], bk[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) a[i] = Cs[(ty + 16 * i) * ldn + e];
#pragma unroll
          for (int j = 0; j < 4; ++j) bk[j] = Bs[(tx + 16 * j) * ldn + e];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int qi = q0 + ty + 16 * i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int kj = k0 + tx + 16 * j;
            Ss[(ty + 16 * i) * LDS + tx + 16 * j] =
                (kj <= qi && qi < Q) ? s[i][j] * expf(cum[qi] - cum[kj]) : 0.f;
          }
        }
        __syncthreads();  // scores (.) L is complete

#pragma unroll 8
        for (int j = 0; j < T; ++j) {
          float pr[4], xv[PJ];
#pragma unroll
          for (int i = 0; i < 4; ++i) pr[i] = Ss[(ty + 16 * i) * LDS + j];
#pragma unroll
          for (int c = 0; c < PJ; ++c) xv[c] = Xs[j * LDP + tx + 16 * c];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int c = 0; c < PJ; ++c) acc[i][c] = fmaf(pr[i], xv[c], acc[i][c]);
        }
      }

      // the carried state: exp(cum_i) (C_i . S_d)
      float ci[4][PJ];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < PJ; ++c) ci[i][c] = 0.f;
#pragma unroll 4
      for (int e = 0; e < n; ++e) {
        float a[4], sv[PJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = Cs[(ty + 16 * i) * ldn + e];
#pragma unroll
        for (int c = 0; c < PJ; ++c) sv[c] = St[(tx + 16 * c) * ldn + e];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < PJ; ++c) ci[i][c] = fmaf(a[i], sv[c], ci[i][c]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
        if (r < rows) {
          const float g = expf(cum[q0 + r]);
          E* yrow = yg + int64_t(c0 + q0 + r) * ldx;
#pragma unroll
          for (int c = 0; c < PJ; ++c)
            store_f32(yrow + tx + 16 * c, acc[i][c] + g * ci[i][c]);
        }
      }
    }

    // S <- S exp(total) + xbar^T (B (.) decay).  Thread (ty, tx) owns the
    // elements S[ty + 16 i][tx + 16 j]; the sum over the chunk's rows stays
    // in registers, and S is rewritten once every query tile has read it.
    float su[PJ][NJ];
#pragma unroll
    for (int i = 0; i < PJ; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) su[i][j] = 0.f;
    for (int k0 = 0; k0 < Q; k0 += T) {
      const int kcols = min(T, Q - k0);
      __syncthreads();
      stage(Bs, ldn, Bg + int64_t(c0 + k0) * n, n, n, kcols, dec + k0);
      stage(Xs, LDP, xb + int64_t(c0 + k0) * ldx, ldx, P, kcols);
      __syncthreads();
#pragma unroll 4
      for (int j = 0; j < kcols; ++j) {
        float xv[PJ], bv[NJ];
#pragma unroll
        for (int i = 0; i < PJ; ++i) xv[i] = Xs[j * LDP + ty + 16 * i];
#pragma unroll
        for (int c = 0; c < NJ; ++c) {
          const int m = tx + 16 * c;
          bv[c] = m < n ? Bs[j * ldn + m] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < PJ; ++i)
#pragma unroll
          for (int c = 0; c < NJ; ++c) su[i][c] = fmaf(xv[i], bv[c], su[i][c]);
      }
    }
    const float gtot = expf(total);
#pragma unroll
    for (int i = 0; i < PJ; ++i)
#pragma unroll
      for (int c = 0; c < NJ; ++c) {
        const int m = tx + 16 * c;
        if (m < n) {
          float* sp = St + (ty + 16 * i) * ldn + m;
          *sp = *sp * gtot + su[i][c];
        }
      }
    __syncthreads();  // S is complete before the next chunk reads it
  }

  float* so = p.state + (int64_t(b) * H + h) * P * n;
  for (int e = tid; e < P * n; e += THREADS) so[e] = St[(e / n) * ldn + e % n];
}

template <typename E, int P>
cudaError_t launch(const Params& p, int blocks, cudaStream_t stream) {
  const size_t smem = smem_bytes<P>(p.n, p.chunk);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<E, P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return err;
  ssd_scan_kernel<E, P><<<blocks, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Inputs are contiguous.  dtype: 0 = float32, 1 = bfloat16 (xbar, B, C and
// y).  Returns a cudaError_t code; 0 means the launch was accepted.
extern "C" int ssd_scan_fwd(const float* la, const void* xbar, const void* B,
                            const void* C, void* y, float* state, int b,
                            int s, int h, int p, int n, int chunk, int dtype,
                            void* stream) {
  if (b <= 0 || h <= 0 || n <= 0 || n > MAX_N || chunk <= 0 || s <= 0 ||
      s % chunk != 0 || int64_t(b) * h > 0x7fffffff)
    return int(cudaErrorInvalidValue);
  Params prm{la, xbar, B, C, y, state, s, h, n, chunk};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = b * h;
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0 && p == 32) err = launch<float, 32>(prm, blocks, st);
  else if (dtype == 0 && p == 64) err = launch<float, 64>(prm, blocks, st);
  else if (dtype == 0 && p == 128) err = launch<float, 128>(prm, blocks, st);
  else if (dtype == 1 && p == 32) err = launch<__nv_bfloat16, 32>(prm, blocks, st);
  else if (dtype == 1 && p == 64) err = launch<__nv_bfloat16, 64>(prm, blocks, st);
  else if (dtype == 1 && p == 128) err = launch<__nv_bfloat16, 128>(prm, blocks, st);
  return int(err);
}

extern "C" const char* ssd_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
