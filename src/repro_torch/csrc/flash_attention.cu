// Flash-attention forward for Hopper (sm_90a): causal / sliding-window GQA.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (`flash_attention`, body `_kernel`) and computes what it computes:
//   s = (q . k) * scale, masked logits set to -1e30 (causal k <= q with no
//   offset, window k > q - window), an online softmax with the running max,
//   normalizer and accumulator in fp32, and l == 0 -> 1 at the end.
// Inputs are fp32 or bf16, with head dim D in {64, 128, 256} for q, k and v,
// or DeepSeek-V2's MLA pair: q and k at D = 192, v at Dv = 128 (the scale
// stays 1/sqrt(D)); the output has v's head dim and the input's type.  The
// Pallas kernel sizes v and the output by q's D, so it cannot run MLA; the
// JAX model's plain path, whose output follows v, is what this computes.  Query head h reads KV head h / (H / KH) straight from
// the un-repeated K/V, and any row strides are taken (unit last dim, rows
// 16-byte aligned; the wrapper checks).  One block owns (batch b, query head
// h, a tile of query rows); the Pallas kernel's sequential k-block grid axis
// is the loop over key tiles inside the block.  The query tile varies
// slowest in the (flat) grid, reversed under a causal mask, so every head's
// heaviest tiles are issued first and the last blocks to start are the
// short ones.
//
// What bounds it on an H100 SXM.  Qwen2-1.5B prefill (B 4, H 12, KV 2, S 512,
// D 128, causal) is ~3.2 GFLOP over ~29 MB in fp32: ~0.048 ms at 67 TFLOP/s
// on the CUDA cores against ~0.009 ms of memory, so fp32 is bound by
// operations.  RecurrentGemma-9B prefill (B 4, H 16, KV 1, S 512, D 256,
// window 2048, which never bites at 512) is ~8.6 GFLOP: ~0.13 ms.  In bf16
// the tensor cores' 989 TFLOP/s make the same work bound by bytes (~0.004
// and ~0.011 ms).  So the two types get two designs.
//
// bf16: tensor cores, a FlashAttention-2 layout.  A block of 4 warps takes
// 64 query rows, 16 per warp.  S = Q K^T and O += P V run on
// mma.sync m16n8k16 (bf16 in, fp32 accumulation; products of bf16 values
// are exact in fp32, as in the Pallas kernel, which casts to fp32).  K and
// V tiles sit in shared memory with 16-byte chunks XOR-swizzled by row, so
// that ldmatrix (.trans for V) reads without bank conflicts, and are double
// buffered: cp.async brings tile t+1 while tile t is computed, with one
// barrier per key tile.  The online softmax stays in registers; a row's max
// reduces over the 4 lanes of a quad with shuffles, its sum once at the
// end, and only key tiles that hold a masked or ragged pair for the warp's
// rows compute masks.  P is rounded to bf16 in registers and is the A
// operand of P V directly; S never goes to shared memory.  Rounding P
// departs from the Pallas kernel, which keeps P in fp32; at the main shapes
// the worst error stays under half the 2e-2 tolerance, so P V is one bf16
// product.  At D <= 128, and at MLA's 192 / 128 (48 registers of Q beside
// 64 of O), the warp keeps its Q fragments in registers (64 keys a tile); at
// D = 256 the O accumulator alone is 128 fp32 registers a thread, so Q stays
// in shared memory and is re-read with ldmatrix per k-step, with 32-key
// tiles.
//
// fp32: exact, on the CUDA cores (no TF32).  A 16 x TY thread grid; thread
// (ty, tx) owns rows ty + TY i of both S and O (4 of them), keys tx + 16 j of
// S and columns 4 tx + 64 j of O.  Q and K are read as float4 along d:
// 8 LDS.128 for 64 FMAs.  K rows are chunk-swizzled (no padding) so the
// float4 reads of 8 different keys hit distinct banks.  The 16 threads of
// one row form a half-warp, so the softmax is in registers with 4 shuffles
// for the max and 4 for the sum; only P goes through shared memory, for
// P V.  K and V have their own buffers: V of tile t loads (cp.async) while
// S is computed, K of tile t+1 while P V is.  Shared memory is sized for
// two blocks an SM: 64 x 64 tiles at D = 128 (112 KB), 32 x 32 at D = 256
// (100 KB, Q, K, V and P) and at 192 / 128 (68 KB).
//
// Key tiles that a whole query tile cannot see (above the causal diagonal,
// before the window) are skipped.  That is exact for every row with at
// least one visible key: a masked logit enters as exp(-1e30 - m) == 0, or
// is wiped by alpha == 0 when the first visible key arrives.  A row with no
// visible key at all (only when Sq > Sk, or with a window) gets the mean of
// v over all Sk keys in the Pallas kernel and in the reference, because
// every logit is the same finite -1e30; a tile that holds such a row
// therefore walks every key tile.  Those rows are always the last rows of a
// tile (emptiness grows with q), so testing the tile's last row suffices.
// Columns past Sk in a ragged last tile are -inf, so they add nothing, and
// the rows past Sk are zero-filled by the copies.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libflash_attention.so flash_attention.cu

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

constexpr float MASKED = -1e30f;  // the Pallas kernel's NEG_INF
constexpr float LOG2E = 1.4426950408889634f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int64_t q_sb, q_sh, q_ss;  // strides in elements; the last dim is unit
  int64_t k_sb, k_sh, k_ss;
  int64_t v_sb, v_sh, v_ss;
  int64_t o_sb, o_sh, o_ss;
  int B, H, KH, Sq, Sk;
  int causal;
  int window;  // > 0: keys k > q - window are visible; <= 0: no window
  float scale;
};

// The key tiles [t0, t0 + nt) of width BK that hold every visible key of
// every row of the query tile [q0, q0 + rows).
struct KeyRange {
  int t0, nt;
};
template <int BK>
__device__ __forceinline__ KeyRange key_range(const Params& p, int q0,
                                              int rows) {
  const bool windowed = p.window > 0;
  const int qlast = q0 + rows - 1;
  int lo = windowed ? max(0, q0 - p.window + 1) : 0;
  int hi = p.causal ? min(p.Sk, qlast + 1) : p.Sk;
  const int last_lo = windowed ? max(0, qlast - p.window + 1) : 0;
  if (last_lo >= hi) {  // the last row sees no key: walk all keys
    lo = 0;
    hi = p.Sk;
  }
  const int t0 = lo / BK;
  return {t0, (hi + BK - 1) / BK - t0};
}

// Whether some pair of query rows [qlo, qhi] and keys [k0, k0 + bk) is
// masked or past Sk; tiles with none skip the per-element masks.
__device__ __forceinline__ bool tile_masked(const Params& p, int qlo, int qhi,
                                            int k0, int bk) {
  return k0 + bk > p.Sk || (p.causal && k0 + bk - 1 > qlo) ||
         (p.window > 0 && k0 <= qhi - p.window);
}

// (query tile, head, batch) of this block: the grid is flat, the tile
// varies slowest and runs last to first under a causal mask.
struct BlockIndex {
  int qt, h, b;
};
__device__ __forceinline__ BlockIndex block_index(const Params& p) {
  const int hb = p.H * p.B;
  const int bh = blockIdx.x % hb, t = blockIdx.x / hb, nq = gridDim.x / hb;
  return {p.causal ? nq - 1 - t : t, bh % p.H, bh / p.H};
}

// The logit of query row qi and key ki, scaled by `scale`, or the mask.
__device__ __forceinline__ float masked_logit(const Params& p, float s,
                                              float scale, int qi, int ki) {
  if (ki >= p.Sk) return -INFINITY;
  if ((p.causal && ki > qi) || (p.window > 0 && ki <= qi - p.window))
    return MASKED;
  return s * scale;
}

// ---------------------------------------------------------------- bf16 ---

constexpr int BF_BQ = 64;        // query rows a block, 16 a warp
constexpr int BF_THREADS = 128;  // 4 warps

// Element offset of 16-byte chunk c of row r in a swizzled (rows, D) bf16
// tile: the chunk index is XORed with the row's low 3 bits.
template <int D>
__device__ __forceinline__ int swz(int r, int c) {
  return r * D + ((c ^ (r & 7)) << 3);
}

// Issue the copies of rows [row0, row0 + nrows) of a (rows, D) bf16 slab
// into an R x D swizzled tile; rows past nrows are zero-filled.
template <int D, int R>
__device__ __forceinline__ void load_tile_bf16(bf16* dst, const bf16* src,
                                               int64_t ld, int row0,
                                               int nrows) {
  constexpr int DC = D / 8;
  for (int i = threadIdx.x; i < R * DC; i += BF_THREADS) {
    const int r = i / DC, c = i % DC;
    const bool ok = r < nrows;
    cp_async16(dst + swz<D>(r, c),
               ok ? src + int64_t(row0 + r) * ld + c * 8 : src, ok);
  }
}

template <int D, int DV, int BK>
constexpr size_t bf16_smem_bytes() {
  return sizeof(bf16) *
         (size_t(BF_BQ) * D + size_t(2) * BK * D + size_t(2) * BK * DV);
}

// D: the head dim of q and k; DV: that of v and the output.
template <int D, int DV, int BK>
__global__ void __launch_bounds__(BF_THREADS)
    flash_bf16_kernel(const Params p) {
  static_assert(D % 64 == 0 && DV % 64 == 0 && BK % 16 == 0, "tile shape");
  constexpr int NT = BK / 8;   // 8-key n-tiles of S
  constexpr int DT = DV / 8;   // 8-column n-tiles of O
  constexpr int KS = D / 16;   // k-steps of Q K^T
  // Q's fragments (KS x 4 registers) beside O's (DT x 4) and S's (NT x 4)
  constexpr bool QREG = D + DV <= 320;

  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // BQ x D
  bf16* Ks = Qs + BF_BQ * D;                     // 2 x BK x D
  bf16* Vs = Ks + 2 * BK * D;                    // 2 x BK x DV

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, c4 = lane % 4;
  const BlockIndex bi = block_index(p);
  const int q0 = bi.qt * BF_BQ;
  const int h = bi.h, b = bi.b;
  const int kvh = h / (p.H / p.KH);
  const bf16* qp = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* kp = static_cast<const bf16*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const bf16* vp = static_cast<const bf16*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  bf16* op = static_cast<bf16*>(p.o) + b * p.o_sb + h * p.o_sh;

  const int rows = min(BF_BQ, p.Sq - q0);
  const KeyRange kr = key_range<BK>(p, q0, rows);

  load_tile_bf16<D, BF_BQ>(Qs, qp, p.q_ss, q0, rows);
  {
    const int k0 = kr.t0 * BK, kcols = min(BK, p.Sk - k0);
    load_tile_bf16<D, BK>(Ks, kp, p.k_ss, k0, kcols);
    load_tile_bf16<DV, BK>(Vs, vp, p.v_ss, k0, kcols);
  }
  cp_async_commit();

  float o[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  // rows g and g + 8 of the warp's 16: running max (log2 units) and this
  // thread's share of the normalizer
  float m[2] = {MASKED, MASKED}, l[2] = {0.f, 0.f};
  uint32_t qf[QREG ? KS : 1][4];
  const float scale2 = p.scale * LOG2E;
  const int wrow = warp * 16;

  for (int t = 0; t < kr.nt; ++t) {
    cp_async_wait<0>();
    __syncthreads();  // tile t has landed; tile t - 1 is no longer read
    if (t + 1 < kr.nt) {
      const int k1 = (kr.t0 + t + 1) * BK, kcols = min(BK, p.Sk - k1);
      const int nb = (t + 1) & 1;
      load_tile_bf16<D, BK>(Ks + nb * BK * D, kp, p.k_ss, k1, kcols);
      load_tile_bf16<DV, BK>(Vs + nb * BK * DV, vp, p.v_ss, k1, kcols);
    }
    cp_async_commit();
    if constexpr (QREG) {
      if (t == 0) {
#pragma unroll
        for (int kk = 0; kk < KS; ++kk)
          hopper::ldmatrix_x4(
              qf[kk], Qs + swz<D>(wrow + lane % 16, 2 * kk + lane / 16));
      }
    }
    const bf16* Kb = Ks + (t & 1) * BK * D;
    const bf16* Vb = Vs + (t & 1) * BK * DV;
    const int k0 = (kr.t0 + t) * BK;

    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t qa[4];
      if constexpr (QREG) {
#pragma unroll
        for (int e = 0; e < 4; ++e) qa[e] = qf[kk][e];
      } else {
        hopper::ldmatrix_x4(qa,
                            Qs + swz<D>(wrow + lane % 16, 2 * kk + lane / 16));
      }
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t kb[4];
        hopper::ldmatrix_x4(
            kb, Kb + swz<D>(8 * j + lane % 8 + 8 * (lane / 16),
                            2 * kk + (lane / 8) % 2));
        hopper::mma_bf16(s[j], qa, kb[0], kb[1]);
        hopper::mma_bf16(s[j + 1], qa, kb[2], kb[3]);
      }
    }

    // online softmax on rows g (e = 0, 1) and g + 8 (e = 2, 3)
    const bool masked = tile_masked(p, q0 + wrow, q0 + wrow + 15, k0, BK);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = q0 + wrow + g + 8 * (e / 2);
        const int ki = k0 + 8 * j + 2 * c4 + e % 2;
        s[j][e] = masked ? masked_logit(p, s[j][e], scale2, qi, ki)
                         : s[j][e] * scale2;
        mx[e / 2] = fmaxf(mx[e / 2], s[j][e]);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = exp2f(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = exp2f(s[j][e] - m[e / 2]);
        l[e / 2] += s[j][e];
      }
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      o[j][0] *= alpha[0];
      o[j][1] *= alpha[0];
      o[j][2] *= alpha[1];
      o[j][3] *= alpha[1];
    }

    // O += P V, P from the S accumulators as the A operand
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = hopper::pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = hopper::pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = hopper::pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = hopper::pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int j = 0; j < DT; j += 2) {
        uint32_t vb[4];
        hopper::ldmatrix_x4_trans(
            vb, Vb + swz<DV>(16 * kk + lane % 8 + 8 * ((lane / 8) % 2),
                             j + lane / 16));
        hopper::mma_bf16(o[j], pa, vb[0], vb[1]);
        hopper::mma_bf16(o[j + 1], pa, vb[2], vb[3]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = (l[r] == 0.f) ? 1.f : l[r];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = wrow + g + 8 * r;
    if (row < rows) {
      bf16* orow = op + int64_t(q0 + row) * p.o_ss;
#pragma unroll
      for (int j = 0; j < DT; ++j)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + 2 * c4) =
            __floats2bfloat162_rn(o[j][2 * r] / l[r], o[j][2 * r + 1] / l[r]);
    }
  }
}

// ---------------------------------------------------------------- fp32 ---

// Issue the copies of rows [row0, row0 + nrows) of a (rows, D) fp32 slab
// into an R x D tile, 16-byte chunks XOR-swizzled by row when SWZ; rows past
// nrows are zero-filled.
template <int D, int R, int THREADS, bool SWZ>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* src,
                                              int64_t ld, int row0,
                                              int nrows) {
  constexpr int DC = D / 4;
  for (int i = threadIdx.x; i < R * DC; i += THREADS) {
    const int r = i / DC, c = i % DC;
    const bool ok = r < nrows;
    cp_async16(dst + r * D + 4 * (SWZ ? c ^ (r & 7) : c),
               ok ? src + int64_t(row0 + r) * ld + c * 4 : src, ok);
  }
}

template <int D>
struct F32Tiles;  // query rows BQ, keys BK, thread rows TY (16 x TY threads)
template <>
struct F32Tiles<64> {
  static constexpr int BQ = 64, BK = 64, TY = 16;
};
template <>
struct F32Tiles<128> {
  static constexpr int BQ = 64, BK = 64, TY = 16;
};
template <>
struct F32Tiles<192> {  // MLA: q and k at 192, v at 128
  static constexpr int BQ = 32, BK = 32, TY = 8;
};
template <>
struct F32Tiles<256> {
  static constexpr int BQ = 32, BK = 32, TY = 8;
};

template <int D, int DV>
constexpr size_t f32_smem_bytes() {
  using C = F32Tiles<D>;
  return sizeof(float) * (size_t(C::BQ) * D + size_t(C::BK) * D +
                          size_t(C::BK) * DV + size_t(C::BQ) * C::BK);
}

// D: the head dim of q and k; DV: that of v and the output.
template <int D, int DV>
__global__ void __launch_bounds__(16 * F32Tiles<D>::TY, 2)
    flash_f32_kernel(const Params p) {
  constexpr int BQ = F32Tiles<D>::BQ, BK = F32Tiles<D>::BK;
  constexpr int TY = F32Tiles<D>::TY, THREADS = 16 * TY;
  constexpr int R = BQ / TY;   // rows a thread owns
  constexpr int CK = BK / 16;  // keys a thread owns in S
  constexpr int CV = DV / 64;  // float4 columns a thread owns in O
  static_assert(R == 4 && D % 64 == 0 && DV % 64 == 0, "tile shape");

  extern __shared__ __align__(128) float smem[];
  float* Qs = smem;          // BQ x D
  float* Ks = Qs + BQ * D;   // BK x D, swizzled
  float* Vs = Ks + BK * D;   // BK x DV
  float* Ps = Vs + BK * DV;  // BQ x BK

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const BlockIndex bi = block_index(p);
  const int q0 = bi.qt * BQ;
  const int h = bi.h, b = bi.b;
  const int kvh = h / (p.H / p.KH);
  const float* qp = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kp =
      static_cast<const float*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const float* vp =
      static_cast<const float*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  float* op = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh;

  const int rows = min(BQ, p.Sq - q0);
  const KeyRange kr = key_range<BK>(p, q0, rows);

  load_tile_f32<D, BQ, THREADS, false>(Qs, qp, p.q_ss, q0, rows);
  load_tile_f32<D, BK, THREADS, true>(Ks, kp, p.k_ss, kr.t0 * BK,
                                      min(BK, p.Sk - kr.t0 * BK));
  cp_async_commit();

  float4 acc[R][CV];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < CV; ++j) acc[i][j] = make_float4(0.f, 0.f, 0.f, 0.f);
  float m[R], l[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = MASKED;
    l[i] = 0.f;
  }

  for (int t = 0; t < kr.nt; ++t) {
    const int k0 = (kr.t0 + t) * BK, kcols = min(BK, p.Sk - k0);
    cp_async_wait<0>();
    __syncthreads();  // K (and Q) landed; the last P V is done with V and P
    load_tile_f32<DV, BK, THREADS, false>(Vs, vp, p.v_ss, k0, kcols);
    cp_async_commit();

    float s[R][CK];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < CK; ++j) s[i][j] = 0.f;
    // unrolled only with 128 threads (D >= 192, up to 255 registers); at
    // D <= 128 an unrolled loop spills under the 128 registers that two
    // 256-thread blocks an SM leave a thread
#pragma unroll(THREADS == 128 ? 4 : 1)
    for (int d4 = 0; d4 < D / 4; ++d4) {
      float4 kb[CK];
#pragma unroll
      for (int j = 0; j < CK; ++j)
        kb[j] = *reinterpret_cast<const float4*>(
            Ks + (tx + 16 * j) * D + 4 * (d4 ^ (tx & 7)));
#pragma unroll
      for (int i = 0; i < R; ++i) {  // one row of Q at a time: few registers
        const float4 a =
            *reinterpret_cast<const float4*>(Qs + (ty + TY * i) * D + 4 * d4);
#pragma unroll
        for (int j = 0; j < CK; ++j) {
          s[i][j] = fmaf(a.x, kb[j].x, s[i][j]);
          s[i][j] = fmaf(a.y, kb[j].y, s[i][j]);
          s[i][j] = fmaf(a.z, kb[j].z, s[i][j]);
          s[i][j] = fmaf(a.w, kb[j].w, s[i][j]);
        }
      }
    }

    // online softmax in registers; the 16 threads of a row are a half-warp.
    // Every tile takes the masks: beside 64 FMAs a logit they cost little,
    // and a second, unmasked copy of the loop would not fit 128 registers.
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int r = ty + TY * i;
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        s[i][j] = masked_logit(p, s[i][j], p.scale, q0 + r, k0 + tx + 16 * j);
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        const float pr = expf(s[i][j] - mx);
        Ps[r * BK + tx + 16 * j] = pr;
        sum += pr;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float alpha = expf(m[i] - mx);
      m[i] = mx;
      l[i] = l[i] * alpha + sum;
#pragma unroll
      for (int j = 0; j < CV; ++j) {
        acc[i][j].x *= alpha;
        acc[i][j].y *= alpha;
        acc[i][j].z *= alpha;
        acc[i][j].w *= alpha;
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // V landed, P is complete, K is no longer read
    if (t + 1 < kr.nt) {
      const int k1 = k0 + BK;
      load_tile_f32<D, BK, THREADS, true>(Ks, kp, p.k_ss, k1,
                                          min(BK, p.Sk - k1));
    }
    cp_async_commit();

#pragma unroll 2
    for (int c = 0; c < BK; c += 4) {
      float4 pr[R];
#pragma unroll
      for (int i = 0; i < R; ++i)
        pr[i] = *reinterpret_cast<const float4*>(Ps + (ty + TY * i) * BK + c);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float4 vv[CV];
#pragma unroll
        for (int j = 0; j < CV; ++j)
          vv[j] = *reinterpret_cast<const float4*>(Vs + (c + kk) * DV +
                                                   4 * tx + 64 * j);
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const float pk = kk == 0 ? pr[i].x
                           : kk == 1 ? pr[i].y
                           : kk == 2 ? pr[i].z
                                     : pr[i].w;
#pragma unroll
          for (int j = 0; j < CV; ++j) {
            acc[i][j].x = fmaf(pk, vv[j].x, acc[i][j].x);
            acc[i][j].y = fmaf(pk, vv[j].y, acc[i][j].y);
            acc[i][j].z = fmaf(pk, vv[j].z, acc[i][j].z);
            acc[i][j].w = fmaf(pk, vv[j].w, acc[i][j].w);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = ty + TY * i;
    if (r < rows) {
      const float li = (l[i] == 0.f) ? 1.f : l[i];
      float* orow = op + int64_t(q0 + r) * p.o_ss;
#pragma unroll
      for (int j = 0; j < CV; ++j)
        *reinterpret_cast<float4*>(orow + 4 * tx + 64 * j) =
            make_float4(acc[i][j].x / li, acc[i][j].y / li,
                        acc[i][j].z / li, acc[i][j].w / li);
    }
  }
}

template <typename K>
cudaError_t launch_kernel(K kernel, const Params& p, int bq, int threads,
                          size_t smem, bool& ready, cudaStream_t stream) {
  cudaError_t err = hopper::set_smem_once(kernel, smem, ready);
  if (err != cudaSuccess) return err;
  const int64_t blocks = int64_t(p.Sq + bq - 1) / bq * p.H * p.B;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  kernel<<<unsigned(blocks), threads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D, int DV>
cudaError_t launch_f32(const Params& p, cudaStream_t s) {
  using C = F32Tiles<D>;
  static bool ready = false;
  return launch_kernel(flash_f32_kernel<D, DV>, p, C::BQ, 16 * C::TY,
                       f32_smem_bytes<D, DV>(), ready, s);
}

template <int D, int DV, int BK>
cudaError_t launch_bf16(const Params& p, cudaStream_t s) {
  static bool ready = false;
  return launch_kernel(flash_bf16_kernel<D, DV, BK>, p, BF_BQ, BF_THREADS,
                       bf16_smem_bytes<D, DV, BK>(), ready, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  D is the head dim of q and k, Dv that
// of v and o: (D, Dv) is (64, 64), (128, 128), (256, 256) or MLA's
// (192, 128).  Strides are in elements.  Returns a cudaError_t code; 0 means
// the launch was accepted.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int64_t q_sb,
    int64_t q_sh, int64_t q_ss, int64_t k_sb, int64_t k_sh, int64_t k_ss,
    int64_t v_sb, int64_t v_sh, int64_t v_ss, int64_t o_sb, int64_t o_sh,
    int64_t o_ss, int B, int H, int KH, int Sq, int Sk, int D, int Dv,
    int causal, int window, int dtype, float scale, void* stream) {
  if (B <= 0 || H <= 0 || KH <= 0 || H % KH != 0 || Sq <= 0 || Sk <= 0)
    return int(cudaErrorInvalidValue);
  Params p{q,    k,    v,    o,  q_sb, q_sh,   q_ss,   k_sb, k_sh,
           k_ss, v_sb, v_sh, v_ss, o_sb, o_sh,   o_ss,   B,    H,
           KH,   Sq,   Sk,   causal, window, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0 && D == 64 && Dv == 64) err = launch_f32<64, 64>(p, s);
  else if (dtype == 0 && D == 128 && Dv == 128)
    err = launch_f32<128, 128>(p, s);
  else if (dtype == 0 && D == 192 && Dv == 128)
    err = launch_f32<192, 128>(p, s);
  else if (dtype == 0 && D == 256 && Dv == 256)
    err = launch_f32<256, 256>(p, s);
  else if (dtype == 1 && D == 64 && Dv == 64)
    err = launch_bf16<64, 64, 64>(p, s);
  else if (dtype == 1 && D == 128 && Dv == 128)
    err = launch_bf16<128, 128, 64>(p, s);
  else if (dtype == 1 && D == 192 && Dv == 128)
    err = launch_bf16<192, 128, 64>(p, s);
  else if (dtype == 1 && D == 256 && Dv == 256)
    err = launch_bf16<256, 256, 32>(p, s);
  return int(err);
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
