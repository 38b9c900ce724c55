// Mamba2 chunked SSD scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan.py (`ssd_scan`,
// body `_kernel`) and computes what it computes: with la = dt * A (fp32)
// and xbar = x * dt, per chunk of Q rows, cum = cumsum(la) and total =
// cum[Q - 1],
//   y   = (C B^T (.) L) xbar + exp(cum) (.) (C S^T),  L_ij = exp(cum_i - cum_j)
//         for i >= j, else 0
//   S  <- S exp(total) + xbar^T (B (.) exp(total - cum))
// from S = 0, and the final S is the second output.  x, B and C are fp32
// or bf16 (one type for the three), y has their type, S is fp32.  Each type
// has a design of its own.
//
// exp(cum_i - cum_j) is taken only where i >= j.  There it is <= 1, because
// dt >= 0 and A < 0; the JAX code takes it everywhere and masks afterwards,
// which here would compute inf in the masked half.  B and C are read
// through their own row stride, so the wrapper hands the model's column
// slices of the convolution output over without a copy; rows must be
// 16-byte aligned and n a multiple of 8 (the wrapper pads otherwise).
//
// ---- fp32: exact on the CUDA cores (TF32 off), three launches ----------
//
// What bounds it on an H100 SXM.  At the Mamba2-370M prefill (b 4, s 512,
// h 32, p 64, n 128, chunk 256) the least work is ~3.3 GFLOP (C B^T once per
// chunk, since B and C have one group; the masked product, C S^T and the
// state update per head) over ~40 MB: ~0.05 ms at 67 TFLOP/s fp32 against
// ~0.012 ms at 3.35 TB/s, so it is bound by operations.  The sequential part
// is only the state carried from chunk to chunk, p x n per chunk and head.
// The wrapper forms la and xbar.
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
// Shared-memory reads are float4 wherever a thread walks a row.  Tiles read
// by 8 rows at once (B in C B^T, S in C S^T) have their 16-byte chunks
// XOR-swizzled by row instead of padded, so those reads hit distinct banks.
//
// ---- bf16: the four products on the tensor cores (wgmma), two launches --
//
// What bounds it on an H100 SXM.  At the same shape the work is the same
// ~3.3 GFLOP, 0.0033 ms at 989 TFLOP/s bf16, while the function must move
// ~22 MB (x, B, C and y in bf16, dt and the state in fp32): 0.0067 ms at
// 3.35 TB/s, so it is bound by bytes.  The design therefore keeps every
// bf16 tile bf16 from memory to the tensor core, reads x as it lies in
// the model's convolution output (no xbar pass: dt is applied inside),
// leaves out the state pass, and keeps what it must hand from one launch
// to the next small (the state each chunk starts from, and cum, dt and a
// decay factor per step).  Tiles are 64 rows, loaded by TMA (thread 0
// issues, an mbarrier a buffer completes) in the 128-byte swizzle that
// wgmma's descriptors read, n zero-padded to 128 and p to 64.
//   1. chunk states and the carry, one block of two warpgroups per (b, h),
//      walking the chunks in order (so the carry needs no launch of its
//      own), four key tiles in flight: per chunk, cum by the block-wide
//      prefix sum above, written with dt to a (b, h, s) scratch; the state
//      so far (held in wgmma accumulators, warpgroup wg owning n columns
//      64 wg .. 64 wg + 63) is written out for the output step, decayed by
//      exp(total), and S += (x w)^T B with w = dt exp(total - cum): x^T
//      comes from the x tile through ldmatrix.trans into registers, is
//      scaled by w in fp32 and split into bf16 hi + lo, two products on
//      one B tile (B N-major).  The last S is the output.
//   2. outputs, one warpgroup per (b, chunk, group of HG heads, pair of
//      query tiles z and nq - 1 - z): a pair sees nq + 1 key tiles whatever
//      z is, which evens out the causal triangle across blocks.  Its work
//      is one sequence of steps, each loaded while the one before runs:
//      per query tile, C's fragments stay in registers for every product;
//      y starts as exp(cum_i) (C_i . S_c^T) (S_c as hi + lo, K-major), then
//      for each key tile at or below the diagonal C B^T is one product
//      shared by the group's heads, and per head P = C B^T (.) exp(cum_i -
//      cum_j) dt_j is rounded to bf16 into A fragments and y += P x with x
//      N-major.  Below the diagonal every key precedes every query, so with
//      m the key tile's last step exp(cum_i - cum_j) = exp(cum_i - cum_m)
//      exp(cum_m - cum_j), two factors <= 1: one a row here, the other
//      (times dt) a column from the chunk-state step, and P takes two
//      multiplies an element.  Only the diagonal tile takes an exponential
//      an element, and masks.  y goes out through shared memory as whole
//      rows.
//   Roundings: C B^T has bf16 operands and is exact in fp32.  P is rounded
//   to bf16, as B1's bf16 kernel rounds its probabilities (relative 2^-9 an
//   element).  The carried state S and the decay-scaled x of the state
//   update are split into bf16 hi + lo, hi being the value cut to bf16 and
//   lo the rest rounded, which keeps it to ~2^-16 relative, so the state
//   and C S^T lose little beside fp32.  The exponentials of the output
//   step are ex2.approx on cum log2(e).
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
using hopper::mbar_arrive_expect_tx;
using hopper::mbar_wait;
using hopper::tma_load_4d;
using hopper::wgmma_commit;
using hopper::wgmma_fence;
using hopper::wgmma_wait;
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
  const float* la;   // (b, s, h)
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
// Chunks at or past `width` and rows past nrows are zero.  Copied with
// cp.async (the caller commits and waits).  width is a multiple of 8, ld_s
// of 32.
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

template <int P>
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

  const float* xb = static_cast<const float*>(p.xbar) +
                    (int64_t(b) * p.s + c0) * H * P + int64_t(h) * P;
  const float* Bg =
      static_cast<const float*>(p.B) + b * p.b_sb + c0 * p.b_ss;
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

template <int P>
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
  const float* Cg =
      static_cast<const float*>(p.C) + b * p.c_sb + (c0 + q0) * p.c_ss;
  const float* Bg =
      static_cast<const float*>(p.B) + b * p.b_sb + c0 * p.b_ss;
  const float* xb =
      static_cast<const float*>(p.xbar) + (int64_t(b) * p.s + c0) * ldx;
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
  float* yg = static_cast<float*>(p.y) + (int64_t(b) * p.s + c0 + q0) * ldx;
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
        float* yrow = yg + int64_t(row) * ldx + (h0 + hh) * P;
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

template <int P>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  // each kernel may use the shared memory of the largest chunk and state
  static bool ready1 = false, ready3 = false;
  cudaError_t err = hopper::set_smem_once(
      ssd_chunk_states<P>, states_smem_bytes<P>(MAX_CHUNK, MAX_N), ready1);
  if (err != cudaSuccess) return err;
  err = hopper::set_smem_once(ssd_outputs<P>, outputs_smem_bytes<P>(MAX_N),
                              ready3);
  if (err != cudaSuccess) return err;

  ssd_chunk_states<P>
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
  ssd_outputs<P>
      <<<grid, THREADS, outputs_smem_bytes<P>(p.np), stream>>>(p);
  return cudaGetLastError();
}

// ================================================================ bf16 ===
//
// Two launches: chunk states (one block per (b, h), walking the chunks in
// order, so the carry needs no launch of its own), then outputs (one block
// per (b, chunk, group of HG heads, pair of query tiles)).  Tiles are 64
// rows; bf16 tiles sit in shared memory as they are in memory, 128-byte
// column slabs in the 128-byte swizzle, and every product is a wgmma.

constexpr int T = 64;           // rows of a key or query tile
constexpr int NT = 128;         // d_state as the tiles hold it, zero-padded
constexpr int SLAB = T * 128;   // bytes of a 64-row, 64-column bf16 slab
constexpr float LOG2E = 1.4426950408889634f;

struct BfParams {
  const bf16* x;    // (b, s, h, p): rows of h p, strides x_sb, x_ss
  const float* dt;  // (b, s, h)
  const float* A;   // (h,)
  const bf16* B;    // (b, s, n), strides b_sb, b_ss
  const bf16* C;    // (b, s, n), strides c_sb, c_ss
  bf16* y;          // (b, s, h, p)
  float* state;     // (b, h, p, n) fp32
  bf16* carried;    // (b, nc, h, 2, PT, NT): S_c rounded to bf16, then the
                    // remainder rounded to bf16 (chunks c >= 1)
  float4* rows;     // (b, h, s): {cum log2(e), dt, kf, 0} of each step,
                    // kf = exp(cum_m - cum) dt with m the last step of the
                    // step's 64-row tile
  int64_t x_sb, x_ss, b_sb, b_ss, c_sb, c_ss;
  int b, s, h, p, n, Q, nc;
};

// The tiles' TMA maps, 4-d bf16 (width, rows, heads, batch), boxes of 64
// columns in the 128-byte swizzle: x (p, s, h, b), B and C (n, s, 1, b),
// carried (NT, PT, nc h 2, b).
struct BfArgs {
  CUtensorMap x, B, C, S;
  BfParams p;
};

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// Two fp32 values v0, v1 (v0 in the low half) as bf16 pairs hi + lo: hi
// is v cut to bf16 (its top 16 bits), lo = v - hi (exact in fp32) rounded
// to bf16, so that hi + lo is within 2^-16 of v, relatively.
__device__ __forceinline__ void split_bf16(float v0, float v1, uint32_t& hi,
                                           uint32_t& lo) {
  const uint32_t b0 = __float_as_uint(v0) & 0xffff0000u;
  const uint32_t b1 = __float_as_uint(v1) & 0xffff0000u;
  hi = __byte_perm(b0, b1, 0x7632);
  lo = hopper::pack_bf16(v0 - __uint_as_float(b0), v1 - __uint_as_float(b1));
}
// A pair of bf16 values x times fp32 weights w0, w1 (exact in fp32), split.
__device__ __forceinline__ void split_scaled(uint32_t xv, float w0, float w1,
                                             uint32_t& hi, uint32_t& lo) {
  const float2 f =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xv));
  split_bf16(f.x * w0, f.y * w1, hi, lo);
}

// -------------------------------------------- 1. chunk states and carry ---

template <int PT>
struct States {
  static constexpr int THREADS = 256;  // warpgroup wg: n columns 64 wg + ..
  static constexpr int MT = PT / 64;   // 64-row tiles of p
  static constexpr int STAGES = 4;     // key tiles in flight
  static constexpr int X_BYTES = MT * SLAB;  // 64 keys x PT
  static constexpr int STAGE = X_BYTES + 2 * SLAB;  // + 64 keys x NT of B
  static constexpr int S_BYTES = 2 * PT * NT * 2;   // S_c's hi and lo
  static constexpr int DT_REGS = MAX_CHUNK / THREADS;  // next chunk's dt
  static size_t smem(int Q) {  // the tiles, S_c, the barriers, then cum,
                               // dt and weights
    const int ntc = (Q + T - 1) / T;
    return 1024 + size_t(STAGES) * STAGE + S_BYTES + 8 * STAGES +
           sizeof(float) * (2 * Q + ntc * T);
  }
};

template <int PT>
__global__ void __launch_bounds__(256, 1)
    ssd_states_bf16(const __grid_constant__ BfArgs args) {
  using S = States<PT>;
  constexpr int MT = S::MT, NS = S::STAGES;
  const BfParams& p = args.p;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wg = warp / 4, w = warp % 4, g = lane / 4, c4 = lane % 4;
  const int H = p.h, Q = p.Q;
  const int h = blockIdx.x % H, b = blockIdx.x / H;
  const int ntc = (Q + T - 1) / T, ntiles = p.nc * ntc;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align1024(smem_raw);
  unsigned char* Ss = base + NS * S::STAGE;  // S_c hi, then lo (PT x NT)
  uint64_t* full = reinterpret_cast<uint64_t*>(Ss + S::S_BYTES);  // [NS]
  float* cum = reinterpret_cast<float*>(full + NS);  // Q
  float* dtc = cum + Q;  // Q
  float* wt = dtc + Q;   // ntc T: dt exp(total - cum), 0 past the chunk

  const float* dtg = p.dt + int64_t(b) * p.s * H + h;
  float dtn[S::DT_REGS];  // chunk c's dt, loaded a chunk ahead
  auto load_dt = [&](int c) {
#pragma unroll
    for (int k = 0; k < S::DT_REGS; ++k) {
      const int t = tid + S::THREADS * k;
      dtn[k] = (c < p.nc && t < Q) ? dtg[int64_t(c) * Q * H + int64_t(t) * H]
                                   : 0.f;
    }
  };
  load_dt(0);

  // key tile t % ntc of chunk t / ntc by TMA: x's PT columns for head h,
  // then B's NT (zero past p, n and s; rows past the chunk are the next
  // chunk's, and their weights are 0)
  auto stage_tile = [&](int t) {
    unsigned char* st = base + (t % NS) * S::STAGE;
    const int r0 = (t / ntc) * Q + (t % ntc) * T;
    mbar_arrive_expect_tx(full + t % NS, S::STAGE);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
      tma_load_4d(st + mt * SLAB, &args.x, full + t % NS, 64 * mt, r0, h, b);
#pragma unroll
    for (int k = 0; k < 2; ++k)
      tma_load_4d(st + S::X_BYTES + k * SLAB, &args.B, full + t % NS, 64 * k,
                  r0, 0, b);
  };
  if (tid == 0) {
    for (int s = 0; s < NS; ++s) hopper::mbar_init(full + s, 1);
    hopper::fence_mbarrier_init();
    hopper::prefetch_tensormap(&args.x);
    hopper::prefetch_tensormap(&args.B);
    for (int t = 0; t < NS - 1 && t < ntiles; ++t) stage_tile(t);
  }

  // S (PT x NT): thread holds rows 64 mt + 16 w + g + 8 ((i / 2) % 2),
  // columns 64 wg + 8 (i / 4) + 2 c4 + i % 2 of acc[mt][i]
  float acc[MT][32];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[mt][i] = 0.f;

  const float Ah = p.A[h];
  float4* rows_g = p.rows + (int64_t(b) * H + h) * p.s;
  for (int c = 0; c < p.nc; ++c) {
    const int c0 = c * Q;
    __syncthreads();  // the last chunk's reads of cum, dtc and wt are done
#pragma unroll
    for (int k = 0; k < S::DT_REGS; ++k) {
      const int t = tid + S::THREADS * k;
      if (t < Q) {
        dtc[t] = dtn[k];
        cum[t] = dtn[k] * Ah;
      }
    }
    load_dt(c + 1);
    __syncthreads();
    block_cumsum(cum, Q);
    const float total = cum[Q - 1];
    for (int t = tid; t < ntc * T; t += S::THREADS) {
      float wv = 0.f;
      if (t < Q) {
        const float d = dtc[t], c2 = cum[t] * LOG2E;
        const float m2 = cum[min(t / T * T + T - 1, Q - 1)] * LOG2E;
        rows_g[c0 + t] = make_float4(c2, d, exp2f(m2 - c2) * d, 0.f);
        wv = d * expf(total - cum[t]);
      }
      wt[t] = wv;
    }
    if (c > 0) {
      // the state chunk c starts from, as hi + lo, for the output step:
      // staged in shared memory (16-byte chunks XOR-ed with the row), then
      // written as whole rows
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int i = 0; i < 32; i += 2) {
          const int row = 64 * mt + 16 * w + g + 8 * ((i / 2) % 2);
          const int col = 64 * wg + 8 * (i / 4) + 2 * c4;
          const int off = row * (NT * 2) + 16 * ((col / 8) ^ (row & 7)) +
                          2 * (col % 8);
          uint32_t hi, lo;
          split_bf16(acc[mt][i], acc[mt][i + 1], hi, lo);
          *reinterpret_cast<uint32_t*>(Ss + off) = hi;
          *reinterpret_cast<uint32_t*>(Ss + PT * NT * 2 + off) = lo;
        }
      __syncthreads();
      bf16* out = p.carried + ((int64_t(b) * p.nc + c) * H + h) * 2 * PT * NT;
      for (int i = tid; i < 2 * PT * (NT / 8); i += S::THREADS) {
        const int r = i / (NT / 8), k = i % (NT / 8);  // hi rows, lo rows
        *reinterpret_cast<uint4*>(out + r * NT + 8 * k) =
            *reinterpret_cast<const uint4*>(Ss + r * (NT * 2) +
                                            16 * (k ^ (r & 7)));
      }
    }
    const float decay = expf(total);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[mt][i] *= decay;

    for (int kt = 0; kt < ntc; ++kt) {
      const int t = c * ntc + kt;
      __syncthreads();  // wt is in; tile t - 1's buffer is free
      if (tid == 0 && t + NS - 1 < ntiles) stage_tile(t + NS - 1);
      mbar_wait(full + t % NS, (t / NS) & 1);
      const unsigned char* st = base + (t % NS) * S::STAGE;
      // S += (x w)^T B: A from x's tile through ldmatrix.trans, scaled by
      // w and split into hi + lo; B N-major, this warpgroup's slab of n
      const uint64_t db =
          hopper::wgmma_desc_sw128(st + S::X_BYTES + wg * SLAB, SLAB, 1024);
      const float* wk = wt + kt * T;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t ah[4][4], al[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          // lanes 8 m .. 8 m + 7 address matrix m: keys 16 kk + 8 (m / 2)
          // + .., p columns 64 mt + 16 w + 8 (m % 2) + ..
          const int m = lane / 8, row = 16 * kk + 8 * (m / 2) + lane % 8;
          const int chunk = 2 * w + m % 2;
          uint32_t xr[4];
          hopper::ldmatrix_x4_trans(
              xr, st + mt * SLAB + row * 128 + 16 * (chunk ^ (row & 7)));
          const float* wr = wk + 16 * kk + 2 * c4;
          split_scaled(xr[0], wr[0], wr[1], ah[kk][0], al[kk][0]);
          split_scaled(xr[1], wr[0], wr[1], ah[kk][1], al[kk][1]);
          split_scaled(xr[2], wr[8], wr[9], ah[kk][2], al[kk][2]);
          split_scaled(xr[3], wr[8], wr[9], ah[kk][3], al[kk][3]);
        }
        hopper::fence_regs(acc[mt]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          hopper::wgmma_m64n64k16_rs_tn(acc[mt], ah[kk], db + kk * 128);
          hopper::wgmma_m64n64k16_rs_tn(acc[mt], al[kk], db + kk * 128);
        }
        wgmma_commit();
        wgmma_wait<0>();
        hopper::fence_regs(acc[mt]);
      }
    }
  }

  float* out = p.state + (int64_t(b) * H + h) * p.p * p.n;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int row = 64 * mt + 16 * w + g + 8 * ((i / 2) % 2);
      const int col = 64 * wg + 8 * (i / 4) + 2 * c4;
      if (row < p.p && col < p.n)
        *reinterpret_cast<float2*>(out + row * p.n + col) =
            make_float2(acc[mt][i], acc[mt][i + 1]);
    }
}

// ----------------------------------------------------------- 2. outputs ---

template <int PT, int HG>
struct Outs {
  static constexpr int THREADS = 128;  // one warpgroup
  static constexpr int X_BYTES = (PT / 64) * SLAB;  // 64 keys x PT, a head
  static constexpr int R_BYTES = T * 16;  // 64 rows of `rows`, a head
  // a head's S_c comes in S_STEPS steps of 128 / S_STEPS columns of n,
  // each as hi and lo
  static constexpr int S_STEPS = PT == 64 ? 1 : 2;
  static constexpr int S_SLABS = 2 / S_STEPS;  // 64-column slabs a step
  static constexpr int S_BYTES = 2 * S_SLABS * PT * 128;
  // a step's buffer: the B tile, then each head's x tile and rows; or a
  // step of one head's S_c.  1024-byte aligned
  static constexpr int STAGE =
      (umax(2 * SLAB + HG * (X_BYTES + R_BYTES), S_BYTES) + 1023) / 1024 *
      1024;
  static constexpr int C_BYTES = 2 * SLAB + HG * R_BYTES;  // + query rows
  static constexpr int Y_BYTES = PT * 128;  // 64 x PT bf16
  // + a barrier a buffer
  static constexpr size_t SMEM = 1024 + 2 * STAGE + C_BYTES + Y_BYTES + 16;
};

// d (64 x PT) (+)= a b^T, b (PT x 16) K-major; d (64 x PT) += a b, b
// (16 x PT) N-major: the wgmma of width PT
template <int PT>
__device__ __forceinline__ void mma_kmajor(float (&d)[PT / 2],
                                           const uint32_t (&a)[4],
                                           uint64_t b) {
  if constexpr (PT == 64) hopper::wgmma_m64n64k16_rs(d, a, b, 1);
  else hopper::wgmma_m64n128k16_rs(d, a, b, 1);
}
template <int PT>
__device__ __forceinline__ void mma_nmajor(float (&d)[PT / 2],
                                           const uint32_t (&a)[4],
                                           uint64_t b) {
  if constexpr (PT == 64) hopper::wgmma_m64n64k16_rs_tn(d, a, b);
  else hopper::wgmma_m64n128k16_rs_tn(d, a, b);
}

// The block's work as one sequence of steps, each loaded into one of two
// buffers while the step before runs: per query tile (z, then nq - 1 - z)
// first each head's S_c (none in the first chunk), then the key tiles
// 0 .. qt.  The first step of a query tile also loads its C tile
// and query rows.
struct OutStep {
  int u;   // query tile of the pair: 0 or 1
  int qt;  // its index in the chunk
  int l;   // step within the query tile
  int ns;  // steps of S_c in the query tile
};

__device__ __forceinline__ OutStep out_step(int j, int nq, int ns) {
  const int z = blockIdx.z, first = ns + z + 1;
  if (j < first) return {0, z, j, ns};
  return {1, nq - 1 - z, j - first, ns};
}

template <int PT, int HG>
__global__ void __launch_bounds__(128, 2)
    ssd_outputs_bf16(const __grid_constant__ BfArgs args) {
  using O = Outs<PT, HG>;
  const BfParams& p = args.p;
  constexpr int NP = PT / 2;  // accumulators of a 64 x PT tile, a thread
  const int tid = threadIdx.x, w = tid / 32, lane = tid % 32;
  const int g = lane / 4, c4 = lane % 4;
  const int H = p.h, Q = p.Q, nq = (Q + T - 1) / T;
  const int groups = (H + HG - 1) / HG;
  const int gi = blockIdx.x % groups, bc = blockIdx.x / groups;
  const int b = bc / p.nc, c = bc % p.nc, c0 = c * Q;
  const int h0 = gi * HG, nh = min(HG, H - h0);
  const int ns = c > 0 ? O::S_STEPS * nh : 0;
  const int z = blockIdx.z, zb = nq - 1 - z;
  const int steps = (ns + z + 1) + (zb != z ? ns + zb + 1 : 0);

  extern __shared__ unsigned char smem_raw[];
  unsigned char* stages = align1024(smem_raw);
  unsigned char* Cs = stages + 2 * O::STAGE;  // 64 queries x NT
  const float4* Rq = reinterpret_cast<const float4*>(Cs + 2 * SLAB);
  unsigned char* Ys = Cs + O::C_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(Ys + O::Y_BYTES);  // [2]

  const int64_t ldy = int64_t(H) * p.p;
  const float4* rows_g = p.rows + int64_t(b) * H * p.s + c0;
  // rows r0 .. r0 + 63 of each head's `rows` (zero past the chunk)
  auto stage_rows = [&](unsigned char* dst, int r0) {
    const int nr = min(T, Q - r0);
#pragma unroll
    for (int hh = 0; hh < HG; ++hh) {
      const float4* src = rows_g + int64_t(h0 + hh) * p.s + r0;
      const bool ok = hh < nh && tid < nr;
      if (tid < T) cp_async16(dst + hh * O::R_BYTES + 16 * tid,
                              ok ? src + tid : rows_g, ok);
    }
  };
  // step j's tiles by TMA from thread 0, on the barrier of its buffer (zero
  // past p, n and s; rows past the chunk are the next chunk's: their
  // weights are masked or their outputs dropped), and its rows of `rows`
  // by cp.async from every thread
  auto issue = [&](int j) {
    const OutStep st = out_step(j, nq, ns);
    unsigned char* buf = stages + (j & 1) * O::STAGE;
    uint64_t* bar = full + (j & 1);
    const int k0 = (st.l - ns) * T;
    if (tid == 0) {
      const int bytes = (st.l == 0 ? 2 * SLAB : 0) +
                        (st.l < ns ? O::S_BYTES : 2 * SLAB + nh * O::X_BYTES);
      mbar_arrive_expect_tx(bar, bytes);
      if (st.l == 0)
#pragma unroll
        for (int k = 0; k < 2; ++k)
          tma_load_4d(Cs + k * SLAB, &args.C, bar, 64 * k, c0 + st.qt * T, 0,
                      b);
      if (st.l < ns) {  // step n2 of head hs's S_c: hi, then lo
        constexpr int SW = O::S_SLABS;
        const int hs = st.l / O::S_STEPS, n2 = st.l % O::S_STEPS;
#pragma unroll
        for (int part = 0; part < 2; ++part)
#pragma unroll
          for (int k = 0; k < SW; ++k)
            tma_load_4d(buf + (part * SW + k) * (PT * 128), &args.S, bar,
                        64 * (SW * n2 + k), 0,
                        ((c * H + h0 + hs) * 2 + part), b);
      } else {
#pragma unroll
        for (int k = 0; k < 2; ++k)
          tma_load_4d(buf + k * SLAB, &args.B, bar, 64 * k, c0 + k0, 0, b);
        for (int hh = 0; hh < nh; ++hh)
#pragma unroll
          for (int mt = 0; mt < PT / 64; ++mt)
            tma_load_4d(buf + 2 * SLAB + hh * O::X_BYTES + mt * SLAB,
                        &args.x, bar, 64 * mt, c0 + k0, h0 + hh, b);
      }
    }
    if (st.l == 0) stage_rows(Cs + 2 * SLAB, st.qt * T);
    if (st.l >= ns) stage_rows(buf + 2 * SLAB + HG * O::X_BYTES, k0);
  };

  uint32_t cf[8][4];  // C's A fragments for the 8 k-steps of n
  float cq[HG][2];    // cum (log2 units) of rows 16 w + g + 8 e
  float y[HG][NP];
  if (tid == 0) {
    hopper::mbar_init(full, 1);
    hopper::mbar_init(full + 1, 1);
    hopper::fence_mbarrier_init();
  }
  __syncthreads();
  issue(0);
  cp_async_commit();
  for (int j = 0; j < steps; ++j) {
    cp_async_wait<0>();
    mbar_wait(full + (j & 1), (j >> 1) & 1);
    __syncthreads();  // step j is in; the other buffer is free
    const OutStep st = out_step(j, nq, ns);
    const unsigned char* buf = stages + (j & 1) * O::STAGE;
    const int q0 = st.qt * T;
    if (st.l == 0) {
      // lanes 0-15 rows 0-15 of the warp's 16 at the k-step's first 8
      // columns of n, lanes 16-31 the next 8
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const int row = 16 * w + lane % 16, chunk = 2 * (kk % 4) + lane / 16;
        hopper::ldmatrix_x4(cf[kk], Cs + (kk / 4) * SLAB + row * 128 +
                                        16 * (chunk ^ (row & 7)));
      }
#pragma unroll
      for (int hh = 0; hh < HG; ++hh) {
        cq[hh][0] = Rq[hh * T + 16 * w + g].x;
        cq[hh][1] = Rq[hh * T + 16 * w + g + 8].x;
#pragma unroll
        for (int i = 0; i < NP; ++i) y[hh][i] = 0.f;
      }
      __syncthreads();  // C is read: the next step may load the next one
    }
    if (j + 1 < steps) issue(j + 1);
    cp_async_commit();
    if (st.l < ns) {
      // y_h += C S_c^T over this step's columns of n (S_c as hi + lo,
      // K-major); after the last, y_h = exp(cum_i) (C_i . S_c)
      constexpr int SW = O::S_SLABS;
      const int hs = st.l / O::S_STEPS, n2 = st.l % O::S_STEPS;
      const uint64_t ds = hopper::wgmma_desc_sw128(buf, 16, 1024);
#pragma unroll
      for (int hh = 0; hh < HG; ++hh) {
        if (hh != hs) continue;
        hopper::fence_regs(y[hh]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4 * SW; ++kk)
#pragma unroll
          for (int lo = 0; lo < 2; ++lo)
            mma_kmajor<PT>(y[hh], cf[4 * SW * n2 + kk],
                           ds + (lo * SW + kk / 4) * (PT * 128 / 16) +
                               2 * (kk % 4));
        wgmma_commit();
        wgmma_wait<0>();
        hopper::fence_regs(y[hh]);
        if (n2 == O::S_STEPS - 1)
#pragma unroll
          for (int i = 0; i < NP; ++i)
            y[hh][i] *= hopper::ex2(cq[hh][(i / 2) % 2]);
      }
    } else {
      const int kt = st.l - ns;
      // C B^T of the key tile, once for the group's heads; B K-major
      float sc[32];
      const uint64_t dk = hopper::wgmma_desc_sw128(buf, 16, 1024);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        hopper::wgmma_m64n64k16_rs(
            sc, cf[kk], dk + (kk / 4) * (SLAB / 16) + 2 * (kk % 4), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      hopper::fence_regs(sc);
      const bool diag = kt == st.qt;
      const float4* rk =
          reinterpret_cast<const float4*>(buf + 2 * SLAB + HG * O::X_BYTES);
#pragma unroll
      for (int hh = 0; hh < HG; ++hh) {
        if (hh >= nh) break;
        // P_ij = (C B^T)_ij exp(cum_i - cum_j) dt_j for j <= i, rounded to
        // bf16 as the A fragments of P x: sc[4 jt + 2 r + e] is row
        // 16 w + g + 8 r, column 8 jt + 2 c4 + e.  Below the diagonal
        // every key precedes every query, and with m the tile's last key
        // exp(cum_i - cum_j) = exp(cum_i - cum_m) exp(cum_m - cum_j), both
        // factors <= 1: a row factor here, the column one (kf, times dt)
        // from the chunk-state step.  The diagonal tile takes each
        // exponential and masks.
        uint32_t pa[4][4];
        auto make_p = [&](auto weight) {
#pragma unroll
          for (int jt = 0; jt < 8; ++jt) {
            float v[2][2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int col = 8 * jt + 2 * c4 + e;
              const float4 kv = rk[hh * T + col];
#pragma unroll
              for (int r = 0; r < 2; ++r)
                v[r][e] = weight(sc[4 * jt + 2 * r + e], kv, r, col);
            }
            pa[jt / 2][2 * (jt % 2)] = hopper::pack_bf16(v[0][0], v[0][1]);
            pa[jt / 2][2 * (jt % 2) + 1] =
                hopper::pack_bf16(v[1][0], v[1][1]);
          }
        };
        if (diag) {
          make_p([&](float sv, const float4& kv, int r, int col) {
            return col > 16 * w + g + 8 * r
                       ? 0.f
                       : sv * hopper::ex2(cq[hh][r] - kv.x) * kv.y;
          });
        } else {
          float aq[2];
#pragma unroll
          for (int r = 0; r < 2; ++r)
            aq[r] = hopper::ex2(cq[hh][r] - rk[hh * T + T - 1].x);
          make_p([&](float sv, const float4& kv, int r, int) {
            return sv * aq[r] * kv.z;
          });
        }
        // y += P x: x N-major, 16 keys a k-step
        const uint64_t dx =
            hopper::wgmma_desc_sw128(buf + 2 * SLAB + hh * O::X_BYTES, SLAB,
                                     1024);
        hopper::fence_regs(y[hh]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          mma_nmajor<PT>(y[hh], pa[kk], dx + kk * 128);
        wgmma_commit();
        wgmma_wait<0>();
        hopper::fence_regs(y[hh]);
      }
      if (kt < st.qt) continue;
      // the query tile is done: y in bf16, staged with 16-byte chunks
      // XOR-ed with the row so that the stores to memory are whole rows
      const int qr = min(T, Q - q0);
#pragma unroll
      for (int hh = 0; hh < HG; ++hh) {
        if (hh >= nh) break;
        if (hh > 0) __syncthreads();  // the last head's y is out
#pragma unroll
        for (int i = 0; i < NP; i += 2) {
          const int r = 16 * w + g + 8 * ((i / 2) % 2);
          const int col = 8 * (i / 4) + 2 * c4;
          *reinterpret_cast<uint32_t*>(Ys + r * (PT * 2) +
                                       16 * ((col / 8) ^ (r & 7)) +
                                       2 * (col % 8)) =
              hopper::pack_bf16(y[hh][i], y[hh][i + 1]);
        }
        __syncthreads();
        bf16* yg =
            p.y + (int64_t(b) * p.s + c0 + q0) * ldy + (h0 + hh) * p.p;
        for (int i = tid; i < T * (PT / 8); i += O::THREADS) {
          const int r = i / (PT / 8), k = i % (PT / 8);
          if (r < qr && 8 * k < p.p)
            *reinterpret_cast<uint4*>(yg + r * ldy + 8 * k) =
                *reinterpret_cast<const uint4*>(Ys + r * (PT * 2) +
                                                16 * (k ^ (r & 7)));
        }
      }
    }
  }
}

template <int PT, int HG>
cudaError_t launch_bf16(const BfParams& p, cudaStream_t stream) {
  static bool ready1 = false, ready2 = false;
  const hopper::EncodeTiled encode = hopper::encode_tiled();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  BfArgs a;
  a.p = p;
  if (!hopper::encode_bf16_map(&a.x, encode, p.x, p.p, p.s, p.h, p.b, p.x_ss,
                               p.p, p.x_sb, T) ||
      !hopper::encode_bf16_map(&a.B, encode, p.B, p.n, p.s, 1, p.b, p.b_ss,
                               p.b_ss, p.b_sb, T) ||
      !hopper::encode_bf16_map(&a.C, encode, p.C, p.n, p.s, 1, p.b, p.c_ss,
                               p.c_ss, p.c_sb, T) ||
      !hopper::encode_bf16_map(&a.S, encode, p.carried, NT, PT, 2 * p.nc * p.h,
                               p.b, NT, int64_t(PT) * NT,
                               int64_t(2) * p.nc * p.h * PT * NT, PT))
    return cudaErrorInvalidValue;
  cudaError_t err = hopper::set_smem_once(
      ssd_states_bf16<PT>, States<PT>::smem(MAX_CHUNK), ready1);
  if (err != cudaSuccess) return err;
  err = hopper::set_smem_once(ssd_outputs_bf16<PT, HG>, Outs<PT, HG>::SMEM,
                              ready2);
  if (err != cudaSuccess) return err;
  ssd_states_bf16<PT><<<unsigned(p.b * p.h), States<PT>::THREADS,
                        States<PT>::smem(p.Q), stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int groups = (p.h + HG - 1) / HG, nq = (p.Q + T - 1) / T;
  const dim3 grid(unsigned(int64_t(p.b) * p.nc * groups), 1, (nq + 1) / 2);
  ssd_outputs_bf16<PT, HG>
      <<<grid, Outs<PT, HG>::THREADS, Outs<PT, HG>::SMEM, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// fp32: xbar and la are contiguous; B and C have unit last stride, 16-byte
// aligned rows and n a multiple of 8.  chunk_states (b, s / chunk, h, p, n)
// and cum (b, h, s) are fp32 scratch.  Returns a cudaError_t code; 0 means
// every launch was accepted.
extern "C" int ssd_scan_fwd(const float* la, const float* xbar, const float* B,
                            const float* C, float* y, float* state,
                            float* chunk_states, float* cum, int64_t b_sb,
                            int64_t b_ss, int64_t c_sb, int64_t c_ss, int b,
                            int s, int h, int p, int n, int chunk,
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
  if (p == 32) err = launch<32>(prm, st);
  else if (p == 64) err = launch<64>(prm, st);
  else if (p == 128) err = launch<128>(prm, st);
  return int(err);
}

// bf16: x, B and C have unit last stride, 16-byte aligned rows and n a
// multiple of 8, x's heads p apart; dt (b, s, h) and A (h,) are fp32 and
// contiguous, y (b, s, h, p) contiguous.  carried (b, s / chunk, h, 2, PT,
// 128) bf16 and rows (b, h, s, 4) fp32 are scratch, PT = 64 for p <= 64,
// else 128.  Returns a cudaError_t code; 0 means both launches were
// accepted.
extern "C" int ssd_scan_bf16_fwd(const void* x, const float* dt,
                                 const float* A, const void* B,
                                 const void* C, void* y, float* state,
                                 void* carried, float* rows, int64_t x_sb,
                                 int64_t x_ss, int64_t b_sb, int64_t b_ss,
                                 int64_t c_sb, int64_t c_ss, int b, int s,
                                 int h, int p, int n, int chunk,
                                 void* stream) {
  if (b <= 0 || h <= 0 || n <= 0 || n > NT || n % 8 != 0 || chunk <= 0 ||
      chunk > MAX_CHUNK || s <= 0 || s % chunk != 0 ||
      int64_t(b) * (s / chunk) * h > 0x7fffffff)
    return int(cudaErrorInvalidValue);
  BfParams prm{static_cast<const bf16*>(x), dt, A,
               static_cast<const bf16*>(B), static_cast<const bf16*>(C),
               static_cast<bf16*>(y), state, static_cast<bf16*>(carried),
               reinterpret_cast<float4*>(rows), x_sb, x_ss, b_sb, b_ss, c_sb,
               c_ss, b, s, h, p, n, chunk, s / chunk};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p == 32 || p == 64) return int(launch_bf16<64, 2>(prm, st));
  if (p == 128) return int(launch_bf16<128, 1>(prm, st));
  return int(cudaErrorInvalidValue);
}

extern "C" const char* ssd_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
