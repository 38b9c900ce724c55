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
// product is taken in fp32 on the CUDA cores (bf16 tiles are widened to fp32
// as they are staged).
//
// What bounds it on an H100 SXM.  At the Mamba2-370M prefill (b 4, s 512,
// h 32, p 64, n 128, chunk 256) the least work is ~3.3 GFLOP (C B^T once per
// chunk, since B and C have one group; the masked product, C S^T and the
// state update per head) over ~40 MB: ~0.05 ms at 67 TFLOP/s fp32 against
// ~0.012 ms at 3.35 TB/s, so it is bound by operations.  The sequential part
// is only the state carried from chunk to chunk, p x n per chunk and head.
//
// Design: the chunked SSD decomposition of Mamba2 (arXiv:2405.21060 sec. 6),
// in three launches, so that every step but the carry runs in parallel over
// chunks:
//   1. chunk states, one block per (b, chunk, h): cum is a block-wide
//      prefix sum (per-thread segments, then a shuffle scan across them; its
//      order differs from cumsum's, within the fp32 tolerance), written to a
//      (b, h, s) scratch; then delta = xbar^T (B (.) exp(total - cum)) into a
//      (b, nc, h, p, n) fp32 scratch.  32-row tiles of xbar and B are double
//      buffered with cp.async.
//   2. the state pass, one thread per 4 elements of (b, h, p, n): in chunk
//      order S_c = S_{c-1} exp(total_{c-1}) + delta_{c-1}; the state each
//      chunk starts from overwrites its delta, and the last S is the output.
//   3. outputs, one block per (b, chunk, 64-row query tile, group of HG
//      heads), heaviest query tiles first.  For each key tile at or below
//      the diagonal (tiles above it have L = 0, so skipping them is exact) it
//      computes the tile of C B^T once and keeps it in shared memory, then
//      for each head of the group scales it by L_h and adds (C B^T (.) L_h)
//      xbar_h to that head's accumulators, which stay in registers across
//      the key tiles (HG = 4 at p <= 64, 2 at p = 128: 16-64 fp32 a
//      thread).  Last, per head,
//      exp(cum_i) (C_i . S_c) from the state the chunk starts from (none for
//      the first chunk), and y is written.  A group may run past h (h = 5):
//      those heads are skipped.
// exp(cum_i - cum_j) is taken only where i >= j.  There it is <= 1, because
// dt >= 0 and A < 0; the JAX code takes it everywhere and masks afterwards,
// which here would compute inf in the masked half.
//
// Shared-memory reads are float4 wherever a thread walks a row.  Tiles read
// by 8 rows at once (B in C B^T, S in C S^T) have their 16-byte chunks
// XOR-swizzled by row instead of padded, so those reads hit distinct banks.
// B and C are read through their own row stride, so the wrapper hands the
// model's column slices of the convolution output over without a copy; rows
// must be 16-byte aligned and n a multiple of 8 (the wrapper pads
// otherwise).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libssd_scan.so ssd_scan.cu

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using hopper::cp_async16;
using hopper::cp_async_commit;
using hopper::cp_async_wait;
using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;
constexpr int MAX_N = 128;     // d_state the tiles are sized for
constexpr int MAX_CHUNK = 2048;
constexpr int T1 = 32;         // rows a tile in the chunk-state step
constexpr int T3 = 64;         // query and key rows a tile in the output step
constexpr int LDL = T3 + 16;   // row stride of the C B^T and L tiles

__host__ __device__ constexpr size_t umax(size_t a, size_t b) {
  return a > b ? a : b;
}

struct Params {
  const float* la;   // (b, s, h) fp32
  const void* xbar;  // (b, s, h, p)
  const void* B;     // (b, s, n), strides b_sb, b_ss
  const void* C;     // (b, s, n), strides c_sb, c_ss
  void* y;           // (b, s, h, p)
  float* state;      // (b, h, p, n) fp32
  float* chunk;      // (b, nc, h, p, n) fp32 scratch: delta, then S_c
  float* cum;        // (b, h, s) fp32 scratch
  int64_t b_sb, b_ss, c_sb, c_ss;
  int b, s, h, n, Q, nc;
  int np;            // n rounded up to a multiple of 32: the tiles' width
};

// 16-byte chunk layouts of an fp32 tile: plain, XOR-swizzled by the row's
// low 3 bits, or by bits 2..4 of the row (for reads of rows 4 apart).
struct Plain {
  __device__ int operator()(int, int c) const { return c; }
};
struct SwzRow {
  __device__ int operator()(int r, int c) const { return c ^ (r & 7); }
};
struct SwzRow4 {
  __device__ int operator()(int r, int c) const { return c ^ ((r >> 2) & 7); }
};

// Stage rows [0, nrows) of a (rows, width) slab with row stride `ld` into an
// R x ld_s fp32 tile; 4-float chunk c of row r lands at chunk swz(r, c).
// Chunks at or past `width` and rows past nrows are zero.  fp32 is copied
// with cp.async (the caller commits and waits); bf16 is loaded 8 at a time,
// widened and stored.  width is a multiple of 8, ld_s of 32.
template <int R, typename Swz>
__device__ __forceinline__ void stage(float* dst, int ld_s, const float* src,
                                      int64_t ld, int nrows, int width,
                                      Swz swz) {
  const int cols = ld_s / 4;
  for (int i = threadIdx.x; i < R * cols; i += THREADS) {
    const int r = i / cols, c = i % cols;
    const bool ok = r < nrows && 4 * c < width;
    cp_async16(dst + r * ld_s + 4 * swz(r, c),
               ok ? src + int64_t(r) * ld + 4 * c : src, ok);
  }
}
template <int R, typename Swz>
__device__ __forceinline__ void stage(float* dst, int ld_s, const bf16* src,
                                      int64_t ld, int nrows, int width,
                                      Swz swz) {
  const int cols = ld_s / 8;
  for (int i = threadIdx.x; i < R * cols; i += THREADS) {
    const int r = i / cols, c = i % cols;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (r < nrows && 8 * c < width)
      raw = *reinterpret_cast<const uint4*>(src + int64_t(r) * ld + 8 * c);
    const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
    const float2 f0 = __bfloat1622float2(h2[0]), f1 = __bfloat1622float2(h2[1]);
    const float2 f2 = __bfloat1622float2(h2[2]), f3 = __bfloat1622float2(h2[3]);
    *reinterpret_cast<float4*>(dst + r * ld_s + 4 * swz(r, 2 * c)) =
        make_float4(f0.x, f0.y, f1.x, f1.y);
    *reinterpret_cast<float4*>(dst + r * ld_s + 4 * swz(r, 2 * c + 1)) =
        make_float4(f2.x, f2.y, f3.x, f3.y);
  }
}

__device__ __forceinline__ void fma4(float4& acc, float a, const float4& b) {
  acc.x = fmaf(a, b.x, acc.x);
  acc.y = fmaf(a, b.y, acc.y);
  acc.z = fmaf(a, b.z, acc.z);
  acc.w = fmaf(a, b.w, acc.w);
}
__device__ __forceinline__ float dot4(const float4& a, const float4& b,
                                      float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}
__device__ __forceinline__ float comp(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// Inclusive prefix sum of x[0, len) in place, by the whole block.
__device__ void block_cumsum(float* x, int len) {
  __shared__ float warp_sum[THREADS / 32];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int seg = (len + THREADS - 1) / THREADS;
  const int lo = min(len, tid * seg), hi = min(len, lo + seg);
  float run = 0.f;
  for (int t = lo; t < hi; ++t) {
    run += x[t];
    x[t] = run;
  }
  float inc = run;  // inclusive scan of the segment totals within the warp
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float v = __shfl_up_sync(0xffffffffu, inc, off);
    if (lane >= off) inc += v;
  }
  float offset = __shfl_up_sync(0xffffffffu, inc, 1);  // exclusive
  if (lane == 0) offset = 0.f;
  if (lane == 31) warp_sum[warp] = inc;
  __syncthreads();
  for (int w = 0; w < warp; ++w) offset += warp_sum[w];
  for (int t = lo; t < hi; ++t) x[t] += offset;
  __syncthreads();
}

// ------------------------------------------------ 1. chunk states, delta ---

template <int P>
size_t states_smem_bytes(int Q, int np) {
  return sizeof(float) * (size_t(2) * Q + size_t(2) * T1 * (P + np));
}

// PR contiguous floats from shared memory, as float4s (or one float2)
template <int PR>
__device__ __forceinline__ void load_row(float (&dst)[PR], const float* src) {
  if constexpr (PR % 4 == 0) {
#pragma unroll
    for (int i = 0; i < PR; i += 4) {
      const float4 v = *reinterpret_cast<const float4*>(src + i);
      dst[i] = v.x;
      dst[i + 1] = v.y;
      dst[i + 2] = v.z;
      dst[i + 3] = v.w;
    }
  } else {
    static_assert(PR == 2, "rows a thread owns");
    const float2 v = *reinterpret_cast<const float2*>(src);
    dst[0] = v.x;
    dst[1] = v.y;
  }
}

template <typename E, int P>
__global__ void __launch_bounds__(THREADS) ssd_chunk_states(const Params p) {
  constexpr int PR = P / 16;  // state rows a thread owns: PR ty + i
  constexpr int NJ = MAX_N / 64;  // float4 state columns: 4 tx + 64 j
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int H = p.h, Q = p.Q, np = p.np;
  const int h = blockIdx.x % H, bc = blockIdx.x / H;
  const int b = bc / p.nc, c = bc % p.nc, c0 = c * Q;

  extern __shared__ __align__(16) float smem[];
  float* cum = smem;       // Q
  float* dec = cum + Q;    // Q: exp(total - cum)
  float* Xs = dec + Q;     // 2 x T1 x P
  float* Bs = Xs + 2 * T1 * P;  // 2 x T1 x np

  const E* xb = static_cast<const E*>(p.xbar) +
                (int64_t(b) * p.s + c0) * H * P + int64_t(h) * P;
  const E* Bg = static_cast<const E*>(p.B) + b * p.b_sb + c0 * p.b_ss;
  const int64_t ldx = int64_t(H) * P;
  auto stage_tile = [&](int k, int buf) {
    const int r0 = k * T1, rows = min(T1, Q - r0);
    stage<T1>(Xs + buf * T1 * P, P, xb + r0 * ldx, ldx, rows, P, Plain{});
    stage<T1>(Bs + buf * T1 * np, np, Bg + r0 * p.b_ss, p.b_ss, rows, p.n,
              Plain{});
  };
  stage_tile(0, 0);
  cp_async_commit();

  const float* la = p.la + (int64_t(b) * p.s + c0) * H + h;
  for (int t = tid; t < Q; t += THREADS) cum[t] = la[int64_t(t) * H];
  __syncthreads();
  block_cumsum(cum, Q);
  const float total = cum[Q - 1];
  float* cum_g = p.cum + (int64_t(b) * H + h) * p.s + c0;
  for (int t = tid; t < Q; t += THREADS) {
    cum_g[t] = cum[t];
    dec[t] = expf(total - cum[t]);
  }

  float4 acc[PR][NJ];
#pragma unroll
  for (int i = 0; i < PR; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = make_float4(0.f, 0.f, 0.f, 0.f);

  const int ntiles = (Q + T1 - 1) / T1;
  for (int k = 0; k < ntiles; ++k) {
    cp_async_wait<0>();
    __syncthreads();  // tile k (and dec) are ready; tile k - 1 is done
    if (k + 1 < ntiles) stage_tile(k + 1, (k + 1) & 1);
    cp_async_commit();
    const float* X = Xs + (k & 1) * T1 * P;
    const float* Bt = Bs + (k & 1) * T1 * np;
    const int rows = min(T1, Q - k * T1);
#pragma unroll 4
    for (int t = 0; t < rows; ++t) {
      const float d = dec[k * T1 + t];
      float xr[PR];
      load_row<PR>(xr, X + t * P + PR * ty);
#pragma unroll
      for (int i = 0; i < PR; ++i) xr[i] *= d;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        if (4 * tx + 64 * j < np) {
          const float4 bv =
              *reinterpret_cast<const float4*>(Bt + t * np + 4 * tx + 64 * j);
#pragma unroll
          for (int i = 0; i < PR; ++i) fma4(acc[i][j], xr[i], bv);
        }
      }
    }
  }

  float* out = p.chunk + ((int64_t(b) * p.nc + c) * H + h) * P * p.n;
#pragma unroll
  for (int i = 0; i < PR; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = 4 * tx + 64 * j;
      if (col < p.n)
        *reinterpret_cast<float4*>(out + (PR * ty + i) * p.n + col) =
            acc[i][j];
    }
}

// ------------------------------------------------------ 2. state pass ---

__global__ void __launch_bounds__(THREADS) ssd_state_pass(const Params p,
                                                          int P) {
  const int64_t per = int64_t(P) * p.n;  // elements of one (b, h) state
  const int64_t e = (int64_t(blockIdx.x) * THREADS + threadIdx.x) * 4;
  if (e >= int64_t(p.b) * p.h * per) return;
  const int64_t bh = e / per, rem = e % per;
  const int64_t b = bh / p.h, h = bh % p.h;
  const float* cum = p.cum + bh * p.s + p.Q - 1;
  float4 S = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c = 0; c < p.nc; ++c) {
    float4* slot = reinterpret_cast<float4*>(
        p.chunk + ((b * p.nc + c) * p.h + h) * per + rem);
    const float4 d = *slot;
    *slot = S;  // the state chunk c starts from
    const float g = expf(cum[int64_t(c) * p.Q]);
    S = make_float4(fmaf(S.x, g, d.x), fmaf(S.y, g, d.y), fmaf(S.z, g, d.z),
                    fmaf(S.w, g, d.w));
  }
  *reinterpret_cast<float4*>(p.state + e) = S;
}

// ---------------------------------------------------------- 3. outputs ---

template <int P>
struct OutTiles {
  static constexpr int TX = P / 4 < 16 ? P / 4 : 16;  // threads along p
  static constexpr int TY = THREADS / TX;             // threads along rows
  static constexpr int R = T3 / TY;                   // rows a thread owns
  static constexpr int PV = P / (4 * TX);             // float4 columns
  static constexpr int HG = P == 128 ? 2 : 4;         // heads a block
  // p = 128 needs 117 KB of shared memory, so one block an SM; its 64
  // accumulators then get the registers they need without a spill
  static constexpr int MIN_BLOCKS = P == 128 ? 1 : 2;
};

// floats of the region that holds the B tile, then the xbar and L tiles,
// then the S tile
template <int P>
__host__ __device__ size_t outputs_union_floats(int np) {
  return umax(umax(size_t(T3) * np, size_t(T3) * (P + LDL)), size_t(P) * np);
}

template <int P>
size_t outputs_smem_bytes(int np) {
  return sizeof(float) * (size_t(T3) * np + size_t(T3) * LDL +
                          outputs_union_floats<P>(np) +
                          size_t(2) * OutTiles<P>::HG * T3);
}

template <typename E, int P>
__global__ void __launch_bounds__(THREADS, OutTiles<P>::MIN_BLOCKS)
    ssd_outputs(const Params p) {
  using O = OutTiles<P>;
  constexpr int TX = O::TX, TY = O::TY, R = O::R, PV = O::PV, HG = O::HG;
  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;      // y and C S^T
  const int ctx = tid % 16, cty = tid / 16;    // C B^T and L: 4 x 4 each
  const int H = p.h, Q = p.Q, np = p.np;
  const int groups = (H + HG - 1) / HG;
  const int g = blockIdx.x % groups, bc = blockIdx.x / groups;
  const int b = bc / p.nc, c = bc % p.nc, c0 = c * Q;
  const int qt = gridDim.z - 1 - blockIdx.z;  // heaviest first
  const int q0 = qt * T3, rows = min(T3, Q - q0);
  const int h0 = g * HG, nh = min(HG, H - h0);

  extern __shared__ __align__(16) float smem[];
  float* Cs = smem;               // T3 x np
  float* CB = Cs + T3 * np;       // T3 x LDL: C B^T of the key tile
  float* U = CB + T3 * LDL;       // B tile | xbar tile + L tile | S tile
  float* cq = U + outputs_union_floats<P>(np);  // HG x T3: cum, query rows
  float* ck = cq + HG * T3;                     // HG x T3: cum, key rows
  float* Bs = U;
  float* Xs = U;
  float* Ls = U + T3 * P;
  float* Ss = U;

  const int64_t ldx = int64_t(H) * P;
  const E* Cg = static_cast<const E*>(p.C) + b * p.c_sb + (c0 + q0) * p.c_ss;
  const E* Bg = static_cast<const E*>(p.B) + b * p.b_sb + c0 * p.b_ss;
  const E* xb = static_cast<const E*>(p.xbar) + (int64_t(b) * p.s + c0) * ldx;
  const float* cum_g = p.cum + int64_t(b) * H * p.s + c0;

  stage<T3>(Cs, np, Cg, p.c_ss, rows, p.n, Plain{});
  cp_async_commit();
  for (int i = tid; i < HG * T3; i += THREADS) {
    const int hh = i / T3, r = i % T3;
    cq[i] = (hh < nh && r < rows)
                ? cum_g[int64_t(h0 + hh) * p.s + q0 + r] : 0.f;
  }

  float4 acc[HG][R][PV];
#pragma unroll
  for (int hh = 0; hh < HG; ++hh)
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int v = 0; v < PV; ++v)
        acc[hh][r][v] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int kt = 0; kt <= qt; ++kt) {
    const int k0 = kt * T3, kcols = min(T3, Q - k0);
    __syncthreads();  // the last key tile's reads of U are done
    stage<T3>(Bs, np, Bg + k0 * p.b_ss, p.b_ss, kcols, p.n, SwzRow{});
    cp_async_commit();
    for (int i = tid; i < HG * T3; i += THREADS) {
      const int hh = i / T3, r = i % T3;
      ck[i] = (hh < nh && r < kcols)
                  ? cum_g[int64_t(h0 + hh) * p.s + k0 + r] : 0.f;
    }
    cp_async_wait<0>();
    __syncthreads();

    // C B^T of this key tile, once for every head
    {
      float s[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
      for (int n4 = 0; n4 < np / 4; ++n4) {
        float4 a[4], bk[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          a[i] = *reinterpret_cast<const float4*>(Cs + (cty + 16 * i) * np +
                                                  4 * n4);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          bk[j] = *reinterpret_cast<const float4*>(
              Bs + (ctx + 16 * j) * np + 4 * (n4 ^ (ctx & 7)));
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = dot4(a[i], bk[j], s[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          CB[(cty + 16 * i) * LDL + ctx + 16 * j] = s[i][j];
    }

#pragma unroll
    for (int hh = 0; hh < HG; ++hh) {
      if (hh >= nh) break;
      __syncthreads();  // the B tile, or the last head's tiles, are read
      stage<T3>(Xs, P, xb + k0 * ldx + (h0 + hh) * P, ldx, kcols, P,
                Plain{});
      cp_async_commit();
      // L tile: (C B^T)_ij exp(cum_i - cum_j) where j <= i, else 0
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = cty + 16 * i, qi = q0 + r;
        const float ci = cq[hh * T3 + r];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = ctx + 16 * j;
          Ls[r * LDL + col] =
              (k0 + col <= qi && r < rows)
                  ? CB[r * LDL + col] * expf(ci - ck[hh * T3 + col])
                  : 0.f;
        }
      }
      cp_async_wait<0>();
      __syncthreads();
#pragma unroll 2
      for (int j4 = 0; j4 < T3 / 4; ++j4) {
        float4 l4[R];
#pragma unroll
        for (int r = 0; r < R; ++r)
          l4[r] = *reinterpret_cast<const float4*>(Ls + (ty + TY * r) * LDL +
                                                   4 * j4);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float4 xv[PV];
#pragma unroll
          for (int v = 0; v < PV; ++v)
            xv[v] = *reinterpret_cast<const float4*>(
                Xs + (4 * j4 + e) * P + 4 * tx + 4 * TX * v);
#pragma unroll
          for (int r = 0; r < R; ++r)
#pragma unroll
            for (int v = 0; v < PV; ++v)
              fma4(acc[hh][r][v], comp(l4[r], e), xv[v]);
        }
      }
    }
  }

  // the carried state: y += exp(cum_i) (C_i . S_c), then write y
  E* yg = static_cast<E*>(p.y) + (int64_t(b) * p.s + c0 + q0) * ldx;
#pragma unroll
  for (int hh = 0; hh < HG; ++hh) {
    if (hh >= nh) break;
    float4 cs[R][PV];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int v = 0; v < PV; ++v) cs[r][v] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (c > 0) {
      __syncthreads();  // U is free
      const float* Sg =
          p.chunk + ((int64_t(b) * p.nc + c) * H + h0 + hh) * P * p.n;
      stage<P>(Ss, np, Sg, p.n, P, p.n, SwzRow4{});
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      for (int n4 = 0; n4 < np / 4; ++n4) {
        float4 a[R];
#pragma unroll
        for (int r = 0; r < R; ++r)
          a[r] = *reinterpret_cast<const float4*>(Cs + (ty + TY * r) * np +
                                                  4 * n4);
#pragma unroll
        for (int v = 0; v < PV; ++v) {
          float4 s4[4];  // S rows 4 tx + 4 TX v + e, chunk n4
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = 4 * tx + 4 * TX * v + e;
            s4[e] = *reinterpret_cast<const float4*>(
                Ss + row * np + 4 * (n4 ^ ((row >> 2) & 7)));
          }
#pragma unroll
          for (int r = 0; r < R; ++r) {
            cs[r][v].x = dot4(a[r], s4[0], cs[r][v].x);
            cs[r][v].y = dot4(a[r], s4[1], cs[r][v].y);
            cs[r][v].z = dot4(a[r], s4[2], cs[r][v].z);
            cs[r][v].w = dot4(a[r], s4[3], cs[r][v].w);
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int row = ty + TY * r;
      if (row < rows) {
        const float gi = expf(cq[hh * T3 + row]);
        E* yrow = yg + int64_t(row) * ldx + (h0 + hh) * P;
#pragma unroll
        for (int v = 0; v < PV; ++v) {
          const int col = 4 * tx + 4 * TX * v;
          const float4 a = acc[hh][r][v], s = cs[r][v];
          hopper::store_f32(yrow + col + 0, fmaf(gi, s.x, a.x));
          hopper::store_f32(yrow + col + 1, fmaf(gi, s.y, a.y));
          hopper::store_f32(yrow + col + 2, fmaf(gi, s.z, a.z));
          hopper::store_f32(yrow + col + 3, fmaf(gi, s.w, a.w));
        }
      }
    }
  }
}

template <typename E, int P>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  // each kernel may use the shared memory of the largest chunk and state
  static bool ready1 = false, ready3 = false;
  cudaError_t err = hopper::set_smem_once(
      ssd_chunk_states<E, P>, states_smem_bytes<P>(MAX_CHUNK, MAX_N), ready1);
  if (err != cudaSuccess) return err;
  err = hopper::set_smem_once(ssd_outputs<E, P>, outputs_smem_bytes<P>(MAX_N),
                              ready3);
  if (err != cudaSuccess) return err;

  ssd_chunk_states<E, P>
      <<<unsigned(int64_t(p.b) * p.nc * p.h), THREADS,
         states_smem_bytes<P>(p.Q, p.np), stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const int64_t quads = int64_t(p.b) * p.h * P * p.n / 4;
  ssd_state_pass<<<unsigned((quads + THREADS - 1) / THREADS), THREADS, 0,
                   stream>>>(p, P);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const int groups = (p.h + OutTiles<P>::HG - 1) / OutTiles<P>::HG;
  const dim3 grid(unsigned(int64_t(p.b) * p.nc * groups), 1,
                  (p.Q + T3 - 1) / T3);
  ssd_outputs<E, P>
      <<<grid, THREADS, outputs_smem_bytes<P>(p.np), stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// xbar and la are contiguous; B and C have unit last stride, 16-byte aligned
// rows and n a multiple of 8.  chunk_states (b, s / chunk, h, p, n) and cum
// (b, h, s) are fp32 scratch.  dtype: 0 = float32, 1 = bfloat16 (xbar, B, C
// and y).  Returns a cudaError_t code; 0 means every launch was accepted.
extern "C" int ssd_scan_fwd(const float* la, const void* xbar, const void* B,
                            const void* C, void* y, float* state,
                            float* chunk_states, float* cum, int64_t b_sb,
                            int64_t b_ss, int64_t c_sb, int64_t c_ss, int b,
                            int s, int h, int p, int n, int chunk, int dtype,
                            void* stream) {
  if (b <= 0 || h <= 0 || n <= 0 || n > MAX_N || n % 8 != 0 || chunk <= 0 ||
      chunk > MAX_CHUNK ||
      s <= 0 || s % chunk != 0 || int64_t(b) * (s / chunk) * h > 0x7fffffff)
    return int(cudaErrorInvalidValue);
  Params prm{la,   xbar, B,    C,     y,         state, chunk_states,
             cum,  b_sb, b_ss, c_sb,  c_ss,      b,     s,
             h,    n,    chunk, s / chunk, (n + 31) / 32 * 32};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0 && p == 32) err = launch<float, 32>(prm, st);
  else if (dtype == 0 && p == 64) err = launch<float, 64>(prm, st);
  else if (dtype == 0 && p == 128) err = launch<float, 128>(prm, st);
  else if (dtype == 1 && p == 32) err = launch<bf16, 32>(prm, st);
  else if (dtype == 1 && p == 64) err = launch<bf16, 64>(prm, st);
  else if (dtype == 1 && p == 128) err = launch<bf16, 128>(prm, st);
  return int(err);
}

extern "C" const char* ssd_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
