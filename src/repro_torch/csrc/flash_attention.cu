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
// JAX model's plain path (models/layers.py `sdpa`), whose output follows v,
// is what this computes.  Query head h reads KV head h / (H / KH) straight
// from the un-repeated K/V, and any row strides are taken (unit last dim,
// rows 16-byte aligned; the wrapper checks).  The Pallas kernel's
// sequential k-block grid axis is a loop over key tiles inside a block.
//
// What bounds it on an H100 SXM.  Qwen2-1.5B prefill (B 4, H 12, KV 2, S 512,
// D 128, causal) is ~3.2 GFLOP over ~29 MB in fp32: ~0.048 ms at 67 TFLOP/s
// on the CUDA cores against ~0.009 ms of memory, so fp32 is bound by
// operations.  RecurrentGemma-9B prefill (B 4, H 16, KV 1, S 512, D 256,
// window 2048, which never bites at 512) is ~8.6 GFLOP: ~0.13 ms.  DeepSeek-
// V2's MLA prefill (B 4, H = KV = 128, S 512, q/k 192, v 128, causal) is
// ~43 GFLOP: 0.642 ms.  In bf16 the tensor cores' 989 TFLOP/s make the same
// work bound by bytes (~0.004, ~0.011 ms, and 0.100 ms for MLA's ~335 MB).
// So the two types get two designs: in fp32 MLA, whose pair is the widest
// and whose head count fills the card, has one of its own; in bf16 one
// kernel, templated on the pair, takes them all.
//
// fp32 at D = 64, 128, 256.  One block owns (batch b, query head h, a tile
// of query rows); the query tile varies slowest in the (flat) grid, reversed
// under a causal mask, so every head's heaviest tiles are issued first.
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
// (100 KB, Q, K, V and P).
//
// MLA fp32 (flash_mla_f32_kernel), bound by its FMAs: register-blocked like
// an SGEMM micro-kernel.  A block of 128 threads owns 64 query rows; thread
// (ty, tx) owns 8 rows x 4 keys of S (tx + 16 j) and 8 rows x 8 columns of
// O, so a step of 4 along d takes 12 LDS.128 for 128 FMAs in Q K^T and 16
// for 256 in P V.  Key tiles are 64 wide.  K and
// V stream through a ring of two 24 KB slots in quarters of a tile (K's two
// halves of d, V's two halves of the keys), one barrier each, so Q (48 KB),
// P (16 KB) and the ring fit 112 KB and two blocks (8 warps) share an SM,
// each hiding the other's barriers and copies; the copies advance their
// addresses instead of recomputing them.  The softmax branches once a tile
// (masks only where the warp's rows meet one) and uses MUFU.EX2; O is
// rescaled only when some row's max moved.  At 254 registers a thread there
// is no room to double-buffer the operands (that spills), so the loop's
// shared-memory latency is hidden by the other warps alone.
//
// bf16 at every pair (flash_bf16_kernel<Bf16Tiles<D, Dv>>), bound by bytes:
// Hopper's own design.  One persistent block an SM walks work items (a
// 128-row query tile of one head).  A producer warpgroup (one thread, 40
// registers after setmaxnreg) issues TMA loads (cp.async.bulk.tensor,
// 128-byte swizzle, 64-column slabs, tensor maps encoded per call from the
// strides; tools/tensormap_cost.cu times that) completed on mbarriers: Q
// (double buffered across items where shared memory allows; at D = 256 an
// item's first ring stages load before its Q, which waits for the last
// item's epilogue) and K and V, 64 keys a stage, in a 2-stage ring that
// runs on across items, so the next item's loads overlap this one's work.
// Two consumer warpgroups (232 registers) own 64 query rows each.  S = Q K^T
// is wgmma m64n64k16 with K from shared memory; up to D = 192 Q's A
// fragments are loaded once an item into registers (ldmatrix), while at
// D = 256 the O accumulator alone takes 128 registers a thread, so S reads
// Q from shared memory too.  P is rounded to bf16 in registers and O += P V
// is one wgmma m64n{Dv}k16 a 16-key step, V N-major through a transposed
// descriptor.  Up to D = 192 a warpgroup issues S of tile t before P V of
// tile t - 1 and runs the softmax of t while P V is in flight; at D = 256
// that second P spills, so the products go one at a time, and the other
// warpgroup's products fill the gaps.  (Products of bf16 values are exact
// in fp32, as in the Pallas kernel, which casts to fp32; rounding P departs
// from it, which keeps P in fp32, and at the main shapes the worst error
// stays under half the 2e-2 tolerance.)  A warpgroup skips the key tiles
// its rows cannot see.  O is staged in the warp's own rows of the Q buffer
// (32-bit shared addresses: generic ones spilled at D = 256) and leaves in
// whole rows.
// The schedule: where K and V together fit a third of L2 (every prefill but
// MLA's), the items go heaviest first (the tile's rank varies slowest), and
// round k deals them to blocks 0..G-1 when k is even and G-1..0 when it is
// odd, so a round's lightest items land on the blocks that took the
// heaviest before; at the main shapes no block then walks more key tiles
// than the least whole number it could.  Where K and V do not fit (MLA's
// 168 MB), the query tiles of one head are neighbours and a round's G
// blocks take G neighbouring items, so that each head's K and V come from
// memory once and from L2 after.  The schedule is static: B1 runs on
// several streams at once (the async executor's stages), which a counter
// in device memory shared between launches would not survive.
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

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using hopper::cp_async16;
using hopper::cp_async_commit;
using hopper::cp_async_wait;
using hopper::mbar_arrive;
using hopper::mbar_arrive_expect_tx;
using hopper::mbar_init;
using hopper::mbar_wait;
using hopper::tma_load_4d;
using hopper::wgmma_commit;
using hopper::wgmma_desc_sw128;
using hopper::wgmma_fence;
using hopper::wgmma_wait;
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

// masked_logit for the MLA fp32 and the bf16 kernels, with selects instead
// of branches, so that a tile's 32 logits a thread compile to straight-line
// code.
__device__ __forceinline__ float masked_logit_sel(const Params& p, float s,
                                                  float scale, int qi,
                                                  int ki) {
  const bool hidden = (p.causal & (ki > qi)) |
                      ((p.window > 0) & (ki <= qi - p.window));
  const float x = hidden ? MASKED : s * scale;
  return ki >= p.Sk ? -INFINITY : x;
}

// Whether query row q sees some key (it does unless a window, with Sq >
// Sk, leaves it none; emptiness only grows with q).
__device__ __forceinline__ bool has_key(const Params& p, int q) {
  const int lo = p.window > 0 ? max(0, q - p.window + 1) : 0;
  const int hi = p.causal ? min(p.Sk - 1, q) : p.Sk - 1;
  return lo <= hi;
}

// Whether query rows [lo, hi] can leave out keys [k0, k0 + bk): the rows
// are past Sq, or every pair is masked and every row sees a key elsewhere.
// Then the tile adds exactly nothing: after a visible key, exp(-1e30 - m)
// == 0; before one, alpha == 0 wipes it when the key arrives.
__device__ __forceinline__ bool rows_skip_tile(const Params& p, int lo, int hi,
                                               int k0, int bk) {
  if (lo >= p.Sq) return true;
  const bool masked = (p.causal && k0 > hi) ||
                      (p.window > 0 && k0 + bk - 1 <= lo - p.window);
  return masked && has_key(p, hi);
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
struct F32Tiles<256> {
  static constexpr int BQ = 32, BK = 32, TY = 8;
};

template <int D>
constexpr size_t f32_smem_bytes() {
  using C = F32Tiles<D>;
  return sizeof(float) * (size_t(C::BQ) * D + 2 * size_t(C::BK) * D +
                          size_t(C::BQ) * C::BK);
}

// D: the head dim of q, k, v and the output.
template <int D>
__global__ void __launch_bounds__(16 * F32Tiles<D>::TY, 2)
    flash_f32_kernel(const Params p) {
  constexpr int BQ = F32Tiles<D>::BQ, BK = F32Tiles<D>::BK;
  constexpr int TY = F32Tiles<D>::TY, THREADS = 16 * TY;
  constexpr int R = BQ / TY;   // rows a thread owns
  constexpr int CK = BK / 16;  // keys a thread owns in S
  constexpr int CV = D / 64;   // float4 columns a thread owns in O
  static_assert(R == 4 && D % 64 == 0, "tile shape");

  extern __shared__ __align__(128) float smem[];
  float* Qs = smem;         // BQ x D
  float* Ks = Qs + BQ * D;  // BK x D, swizzled
  float* Vs = Ks + BK * D;  // BK x D
  float* Ps = Vs + BK * D;  // BQ x BK

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
    load_tile_f32<D, BK, THREADS, false>(Vs, vp, p.v_ss, k0, kcols);
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
          vv[j] = *reinterpret_cast<const float4*>(Vs + (c + kk) * D +
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

// ------------------------------------------------------------ MLA fp32 ---

// DeepSeek-V2's MLA pair in fp32: q and k at 192, v at 128.  A block of 128
// threads takes 64 query rows as a 16 x 8 thread grid; thread (ty, tx) owns
// rows 8 ty .. 8 ty + 7 of S and O, keys tx + 16 j of S and columns 4 tx +
// 64 j of O.  K and V stream through a ring of two 24 KB slots in quarters
// of a 64-key tile: K's d in [0, 96) and [96, 192), then V's keys [0, 32)
// and [32, 64).
struct MlaF32 {
  static constexpr int D = 192, DV = 128, BQ = 64, BK = 64, THREADS = 128;
  static constexpr int R = 8;   // rows a thread owns
  static constexpr int CK = 4;  // keys a thread owns in S
  static constexpr int CV = 2;  // float4 columns a thread owns in O
  static constexpr int DH = D / 2, KH = BK / 2;  // a K quarter's d, V's keys
  static constexpr int SLOT = BK * DH;           // floats (KH * DV fits)
  // Q, P and the two slots: 112 KB, two blocks an SM
  static constexpr size_t SMEM =
      sizeof(float) * (size_t(BQ) * D + size_t(BQ) * BK + 2 * size_t(SLOT));
};

// Issue the copies of rows [row0, row0 + nrows) of a slab (W fp32 columns
// from `src`, rows `ld` apart) into an R x W tile whose 16-byte chunk c of
// row r sits at chunk c ^ ((r >> SH) & 7), or at c when SH < 0; rows past
// nrows are zero-filled.
template <int W, int R, int THREADS, int SH>
__device__ __forceinline__ void load_slab_f32(float* dst, const float* src,
                                              int64_t ld, int row0,
                                              int nrows) {
  constexpr int WC = W / 4, DR = THREADS / WC, DC = THREADS % WC;
  static_assert(R * WC % THREADS == 0, "whole rounds of copies");
  // thread i copies chunks i, i + THREADS, ...: (row, chunk) and the source
  // advance by (DR, DC), plus a row when the chunk wraps
  int r = threadIdx.x / WC, c = threadIdx.x % WC;
  const float* g = src + int64_t(row0 + r) * ld + 4 * c;
#pragma unroll
  for (int i = 0; i < R * WC / THREADS; ++i) {
    const int sc = SH < 0 ? c : c ^ ((r >> SH) & 7);
    cp_async16(dst + r * W + 4 * sc, r < nrows ? g : src, r < nrows);
    r += DR;
    c += DC;
    g += DR * ld + 4 * DC;
    if (c >= WC) {
      c -= WC;
      r += 1;
      g += ld - 4 * WC;
    }
  }
}

__global__ void __launch_bounds__(MlaF32::THREADS, 2)
    flash_mla_f32_kernel(const Params p) {
  constexpr int D = MlaF32::D, DV = MlaF32::DV, BQ = MlaF32::BQ,
                BK = MlaF32::BK, THREADS = MlaF32::THREADS;
  constexpr int R = MlaF32::R, CK = MlaF32::CK, CV = MlaF32::CV;
  constexpr int DH = MlaF32::DH, KH = MlaF32::KH, SLOT = MlaF32::SLOT;

  extern __shared__ __align__(128) float smem[];
  float* Qs = smem;          // BQ x D, chunks swizzled by (r >> 3) & 7
  float* Ps = Qs + BQ * D;   // BQ x BK, chunks swizzled by ((r >> 3) & 1) * 4
  float* slots = Ps + BQ * BK;  // 2 x SLOT: BK x DH of K swizzled by r & 7,
                                // or KH x DV of V

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
  // the 16 rows of this thread's warp, which skips the tiles they need not
  // see (above the diagonal, before the window)
  const int wlo = q0 + 16 * (ty / 2), whi = wlo + 15;
  const int qc = ty & 7;        // Q's swizzle for rows 8 ty + i
  const int kc = tx & 7;        // K's for keys tx + 16 j
  const int pc = (ty & 1) * 4;  // P's for rows 8 ty + i
  const float scale2 = p.scale * LOG2E;

  // load i of the ring: quarter i % 4 of key tile i / 4, into slot i % 2
  auto issue = [&](int i) {
    const int k0 = (kr.t0 + i / 4) * BK, part = i % 4;
    float* dst = slots + (i & 1) * SLOT;
    if (part < 2) {
      load_slab_f32<DH, BK, THREADS, 0>(dst, kp + part * DH, p.k_ss, k0,
                                        p.Sk - k0);
    } else {
      const int v0 = k0 + (part - 2) * KH;
      load_slab_f32<DV, KH, THREADS, -1>(dst, vp, p.v_ss, v0, p.Sk - v0);
    }
  };
  for (int i = threadIdx.x; i < BQ * (D / 4); i += THREADS) {
    const int r = i / (D / 4), c = i % (D / 4);
    const bool ok = r < rows;
    cp_async16(Qs + r * D + 4 * (c ^ ((r >> 3) & 7)),
               ok ? qp + int64_t(q0 + r) * p.q_ss + c * 4 : qp, ok);
  }
  issue(0);
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
    const int k0 = (kr.t0 + t) * BK;
    const bool skip = rows_skip_tile(p, wlo, whi, k0, BK);
    float s[R][CK];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < CK; ++j) s[i][j] = 0.f;

#pragma unroll 1
    for (int part = 0; part < 4; ++part) {
      const int i = 4 * t + part;
      cp_async_wait<0>();
      __syncthreads();  // load i landed; the other slot is no longer read
      if (i + 1 < 4 * kr.nt) issue(i + 1);
      cp_async_commit();
      if (skip) continue;
      const float* sl = slots + (part & 1) * SLOT;

      if (part < 2) {
        // S += Q K^T over this half of d: per step of 4 along d, 4 float4
        // of K and 8 of Q (16 and 2 distinct addresses in the warp) for
        // 128 FMAs
#pragma unroll 4
        for (int d4 = 0; d4 < DH / 4; ++d4) {
          float4 kb[CK];
#pragma unroll
          for (int j = 0; j < CK; ++j)
            kb[j] = *reinterpret_cast<const float4*>(
                sl + (tx + 16 * j) * DH + 4 * (d4 ^ kc));
          const int qd = (part * (DH / 4) + d4) ^ qc;
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const float4 a = *reinterpret_cast<const float4*>(
                Qs + (8 * ty + r) * D + 4 * qd);
#pragma unroll
            for (int j = 0; j < CK; ++j) {
              s[r][j] = fmaf(a.x, kb[j].x, s[r][j]);
              s[r][j] = fmaf(a.y, kb[j].y, s[r][j]);
              s[r][j] = fmaf(a.z, kb[j].z, s[r][j]);
              s[r][j] = fmaf(a.w, kb[j].w, s[r][j]);
            }
          }
        }
      }

      if (part == 1) {
        // online softmax in registers, in log2 units; the 16 threads of a
        // row are a half-warp.  Only tiles that hold a masked or ragged
        // pair for the warp's rows compute masks.  P goes to shared memory.
        // l holds this thread's share of each row's normalizer; the 16
        // shares are summed once, at the end
        const bool masked = tile_masked(p, wlo, whi, k0, BK);
        float alpha[R];
        bool same = true;  // no row's max moved: O needs no rescale
#pragma unroll
        for (int r = 0; r < R; ++r) {
          float mx;
          if (masked) {
#pragma unroll
            for (int j = 0; j < CK; ++j)
              s[r][j] = masked_logit_sel(p, s[r][j], scale2, q0 + 8 * ty + r,
                                         k0 + tx + 16 * j);
            mx = fmaxf(fmaxf(s[r][0], s[r][1]), fmaxf(s[r][2], s[r][3]));
          } else {
            mx = fmaxf(fmaxf(s[r][0], s[r][1]), fmaxf(s[r][2], s[r][3])) *
                 scale2;
          }
#pragma unroll
          for (int off = 8; off > 0; off >>= 1)
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
          mx = fmaxf(mx, m[r]);
          alpha[r] = hopper::ex2(m[r] - mx);
          same &= alpha[r] == 1.f;
          m[r] = mx;
          float sum = 0.f;
#pragma unroll
          for (int j = 0; j < CK; ++j) {
            const float pr =
                hopper::ex2(masked ? s[r][j] - mx : fmaf(s[r][j], scale2, -mx));
            const int key = tx + 16 * j;
            Ps[(8 * ty + r) * BK + 4 * ((key >> 2) ^ pc) + (key & 3)] = pr;
            sum += pr;
          }
          l[r] = l[r] * alpha[r] + sum;
        }
        if (!__all_sync(0xffffffffu, same)) {
#pragma unroll
          for (int r = 0; r < R; ++r)
#pragma unroll
            for (int j = 0; j < CV; ++j) {
              acc[r][j].x *= alpha[r];
              acc[r][j].y *= alpha[r];
              acc[r][j].z *= alpha[r];
              acc[r][j].w *= alpha[r];
            }
        }
      }

      if (part >= 2) {
        // O += P V over this half of the keys: per 4 keys, 8 float4 of P
        // and 8 of V for 256 FMAs
        const int c0 = (part - 2) * (KH / 4);
#pragma unroll 2
        for (int c = 0; c < KH / 4; ++c) {
          float4 pr[R];
#pragma unroll
          for (int r = 0; r < R; ++r)
            pr[r] = *reinterpret_cast<const float4*>(
                Ps + (8 * ty + r) * BK + 4 * ((c0 + c) ^ pc));
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            float4 vv[CV];
#pragma unroll
            for (int j = 0; j < CV; ++j)
              vv[j] = *reinterpret_cast<const float4*>(
                  sl + (4 * c + kk) * DV + 4 * tx + 64 * j);
#pragma unroll
            for (int r = 0; r < R; ++r) {
              const float pk = kk == 0   ? pr[r].x
                               : kk == 1 ? pr[r].y
                               : kk == 2 ? pr[r].z
                                         : pr[r].w;
#pragma unroll
              for (int j = 0; j < CV; ++j) {
                acc[r][j].x = fmaf(pk, vv[j].x, acc[r][j].x);
                acc[r][j].y = fmaf(pk, vv[j].y, acc[r][j].y);
                acc[r][j].z = fmaf(pk, vv[j].z, acc[r][j].z);
                acc[r][j].w = fmaf(pk, vv[j].w, acc[r][j].w);
              }
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], off);
    const int row = 8 * ty + r;
    if (row < rows) {
      const float inv = 1.f / ((l[r] == 0.f) ? 1.f : l[r]);
      float* orow = op + int64_t(q0 + row) * p.o_ss;
#pragma unroll
      for (int j = 0; j < CV; ++j)
        *reinterpret_cast<float4*>(orow + 4 * tx + 64 * j) =
            make_float4(acc[r][j].x * inv, acc[r][j].y * inv,
                        acc[r][j].z * inv, acc[r][j].w * inv);
    }
  }
}

// ---------------------------------------------------------------- bf16 ---

// The bf16 kernel's tiles at head dims (D of q and k, DV of v): a
// persistent block of two consumer warpgroups, 64 query rows each, and a
// producer warpgroup whose first thread keeps TMA loads in flight.  Every
// tile is a row of 128-byte column slabs (64 bf16 columns each) in the
// 128-byte swizzle.
template <int D_, int DV_>
struct Bf16Tiles {
  static constexpr int D = D_, DV = DV_;
  static constexpr int WGS = 2;  // consumer warpgroups, 64 query rows each
  static constexpr int BQ = 64 * WGS, BK = 64;
  // a producer warpgroup (one thread issues the loads) after the consumers
  static constexpr int CONSUMERS = 128 * WGS, THREADS = CONSUMERS + 128;
  // registers a thread: the producer's 40 leave the consumers 232
  static constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
  static_assert(PRODUCER_REGS * 128 + CONSUMER_REGS * CONSUMERS <= 65536,
                "registers");
  // Q's A fragments (D / 4 registers a thread) fit beside O (DV / 2), S
  // (BK / 2) and P (BK / 4) up to D + DV = 320; past that S reads Q from
  // shared memory
  static constexpr bool QREG = D + DV <= 320;
  // S of one key tile beside P V of the last (a second P in registers)
  // where that fits too: not at D = 256, where it spills
  static constexpr bool OVERLAP = QREG;
  static constexpr int DS = D / 64, DVS = DV / 64;  // slabs of q / k and v
  static constexpr int STAGES = 2;                  // depth of the K / V ring
  static constexpr int Q_SLAB = BQ * 128, KV_SLAB = BK * 128;
  static constexpr int Q_BYTES = DS * Q_SLAB;
  static constexpr int K_BYTES = DS * KV_SLAB, V_BYTES = DVS * KV_SLAB;
  static constexpr int RING = STAGES * (K_BYTES + V_BYTES);
  // Q double buffered across items where that fits (not at D = 256: 64 KB
  // a buffer beside a 128 KB ring)
  static constexpr int QBUFS = 2 * Q_BYTES + RING <= 200 * 1024 ? 2 : 1;
  static constexpr int TILES = QBUFS * Q_BYTES + RING;
  // tiles, the mbarriers, and slack to align the tiles to 1024 B
  static constexpr size_t SMEM = 1024 + TILES + (2 * QBUFS + 4 * STAGES) * 8;
  static_assert(SMEM <= 232448, "shared memory");
  static_assert(D % 64 == 0 && DV % 64 == 0 && DV <= D && DV <= 256,
                "head dims: O is staged in Q's buffer, P V is one wgmma");
};

struct Bf16Args {
  CUtensorMap q, k, v;  // (D or DV, S, heads, B) bf16, 128-byte swizzle
  Params p;
  int heavy_first;  // the schedule (round_item, work_item)
};

// The work item that this block takes in round k (>= the item count when it
// has none).  heavy_first: block c takes item k G + c when k is even and
// k G + G - 1 - c when it is odd (G blocks); else k G + (c + k) % G.
__device__ __forceinline__ int round_item(int k, bool heavy_first) {
  const int g = gridDim.x, c = blockIdx.x;
  return k * g + (heavy_first ? ((k & 1) ? g - 1 - c : c) : (c + k) % g);
}
// Work item i (< nq H B): heavy_first, the tile's rank varies slowest, so
// every head's heaviest tiles come first (block_index's order); else the
// query tiles of one head are neighbours, heaviest first, and a round's G
// neighbouring items cover few heads.
__device__ __forceinline__ BlockIndex work_item(const Params& p, int nq, int i,
                                                bool heavy_first) {
  const int hb = p.H * p.B;
  const int bh = heavy_first ? i % hb : i / nq;
  const int t = heavy_first ? i / hb : i % nq;
  return {p.causal ? nq - 1 - t : t, bh % p.H, bh / p.H};
}

// O (64 x DV of a warpgroup, fp32) += P (in registers) V (16 keys, N-major)
template <int DV>
__device__ __forceinline__ void wgmma_pv(float (&o)[DV / 2],
                                         const uint32_t (&a)[4], uint64_t b) {
  if constexpr (DV == 64) hopper::wgmma_m64n64k16_rs_tn(o, a, b);
  else if constexpr (DV == 128) hopper::wgmma_m64n128k16_rs_tn(o, a, b);
  else hopper::wgmma_m64n256k16_rs_tn(o, a, b);
}

template <class T>
__global__ void __launch_bounds__(T::THREADS, 1)
    flash_bf16_kernel(const __grid_constant__ Bf16Args args) {
  constexpr int BQ = T::BQ, BK = T::BK, D = T::D, DV = T::DV;
  constexpr int Q_SLAB = T::Q_SLAB, KV_SLAB = T::KV_SLAB;
  constexpr int QB = T::QBUFS, NS = T::STAGES;
  const Params& p = args.p;
  const bool heavy = args.heavy_first != 0;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* Qs = base;                  // QB buffers
  unsigned char* Ks = Qs + QB * T::Q_BYTES;  // NS stages
  unsigned char* Vs = Ks + NS * T::K_BYTES;  // NS stages
  uint64_t* full_q = reinterpret_cast<uint64_t*>(base + T::TILES);
  uint64_t* empty_q = full_q + QB;   // [QB]: every consumer warp is done
  uint64_t* full_k = empty_q + QB;   // [NS]: K of the stage has landed
  uint64_t* full_v = full_k + NS;    // [NS]
  uint64_t* empty_k = full_v + NS;   // [NS]
  uint64_t* empty_v = empty_k + NS;  // [NS]

  const int nq = (p.Sq + BQ - 1) / BQ, items = nq * p.H * p.B;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  constexpr uint32_t CONSUMER_WARPS = T::CONSUMERS / 32;

  if (threadIdx.x == 0) {
    for (int i = 0; i < QB; ++i) {
      mbar_init(full_q + i, 1);
      mbar_init(empty_q + i, CONSUMER_WARPS);
    }
    for (int s = 0; s < NS; ++s) {
      mbar_init(full_k + s, 1);
      mbar_init(full_v + s, 1);
      mbar_init(empty_k + s, CONSUMER_WARPS);
      mbar_init(empty_v + s, CONSUMER_WARPS);
    }
    hopper::fence_mbarrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= T::CONSUMERS) {
    // producer: one thread issues every load; a buffer is refilled once
    // all 8 consumer warps have released it
    hopper::setmaxnreg_dec<T::PRODUCER_REGS>();
    if (threadIdx.x == T::CONSUMERS) {
      hopper::prefetch_tensormap(&args.q);
      hopper::prefetch_tensormap(&args.k);
      hopper::prefetch_tensormap(&args.v);
      int tg = 0;  // key tiles loaded so far, across items
      for (int j = 0, i = round_item(0, heavy); i < items;
           i = round_item(++j, heavy)) {
        const BlockIndex w = work_item(p, nq, i, heavy);
        const int q0 = w.qt * BQ, kvh = w.h / (p.H / p.KH);
        const KeyRange kr = key_range<BK>(p, q0, min(BQ, p.Sq - q0));
        const int qb = j % QB;
        // with one Q buffer, Q waits for the last item's epilogue: the
        // item's first ring stages go first, so they load meanwhile
        const int lead = QB == 1 ? min(NS, kr.nt) : 0;
        for (int t = 0; t <= kr.nt; ++t) {
          if (t == lead) {
            mbar_wait(empty_q + qb, ((j / QB) & 1) ^ 1);
            mbar_arrive_expect_tx(full_q + qb, T::Q_BYTES);
            for (int c = 0; c < T::DS; ++c)
              tma_load_4d(Qs + qb * T::Q_BYTES + c * Q_SLAB, &args.q,
                          full_q + qb, 64 * c, q0, w.h, w.b);
          }
          if (t == kr.nt) break;
          const int s = tg % NS, k0 = (kr.t0 + t) * BK;
          const uint32_t par = ((tg / NS) & 1) ^ 1;
          mbar_wait(empty_k + s, par);
          mbar_arrive_expect_tx(full_k + s, T::K_BYTES);
          for (int c = 0; c < T::DS; ++c)
            tma_load_4d(Ks + s * T::K_BYTES + c * KV_SLAB, &args.k,
                        full_k + s, 64 * c, k0, kvh, w.b);
          mbar_wait(empty_v + s, par);
          mbar_arrive_expect_tx(full_v + s, T::V_BYTES);
          for (int c = 0; c < T::DVS; ++c)
            tma_load_4d(Vs + s * T::V_BYTES + c * KV_SLAB, &args.v,
                        full_v + s, 64 * c, k0, kvh, w.b);
          ++tg;
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63 of a tile, its
  // warp w rows 16 w .. 16 w + 15 of those; g = lane / 4 and c4 = lane % 4
  // place a thread in the m16n8 fragments
  hopper::setmaxnreg_inc<T::CONSUMER_REGS>();
  const int wg = warp / 4, w = warp % 4;
  const int g = lane / 4, c4 = lane % 4;
  const float scale2 = p.scale * LOG2E;
  int tg = 0;  // key tiles consumed so far, across items
  for (int j = 0, i = round_item(0, heavy); i < items;
       i = round_item(++j, heavy)) {
    const BlockIndex item = work_item(p, nq, i, heavy);
    const int q0 = item.qt * BQ, rows = min(BQ, p.Sq - q0);
    const KeyRange kr = key_range<BK>(p, q0, rows);
    const int wrow = 64 * wg + 16 * w;
    const int qb = j % QB;
    unsigned char* Qb = Qs + qb * T::Q_BYTES;

    float o[DV / 2];
#pragma unroll
    for (int e = 0; e < DV / 2; ++e) o[e] = 0.f;
    // rows g and g + 8 of the warp's 16: running max (log2 units) and this
    // thread's share of the normalizer
    float m[2] = {MASKED, MASKED}, l[2] = {0.f, 0.f};
    mbar_wait(full_q + qb, (j / QB) & 1);
    // Q's A fragments of the D / 16 k-steps stay in registers for the item
    // (QREG), so that S reads only K from shared memory: lanes 0-15 give
    // rows 0-15 of the warp's 16 at the k-step's first 8 columns, lanes
    // 16-31 the next 8, in the 128-byte swizzle (chunk c of row r at
    // c ^ (r & 7))
    uint32_t qf[T::QREG ? D / 16 : 1][4];
    if constexpr (T::QREG) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int row = wrow + lane % 16, chunk = 2 * (kk % 4) + lane / 16;
        hopper::ldmatrix_x4(qf[kk], Qb + (kk / 4) * Q_SLAB + row * 128 +
                                        16 * (chunk ^ (row & 7)));
      }
    }
    // The warpgroup's tiles are [ta, tb): it skips the ones before (under
    // a window) and after (above the diagonal) that its rows cannot see,
    // releasing their stages unread.  In between (OVERLAP), S of tile t is
    // issued before P V of tile t - 1, which stays in flight while the
    // softmax of tile t runs: the exponentials overlap the tensor cores
    // within the warpgroup too.  No product sits on a branch inside the
    // loop, which would make ptxas serialize them.
    const int tg0 = tg;
    auto stage = [&](int t) { return (tg0 + t) % NS; };
    auto phase = [&](int t) { return uint32_t((tg0 + t) / NS) & 1; };
    auto skips = [&](int t) {
      return rows_skip_tile(p, q0 + 64 * wg, q0 + 64 * wg + 63,
                            (kr.t0 + t) * BK, BK);
    };
    auto release = [&](uint64_t* bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };
    auto pass = [&](int t) {
      mbar_wait(full_k + stage(t), phase(t));
      release(empty_k + stage(t));
      mbar_wait(full_v + stage(t), phase(t));
      release(empty_v + stage(t));
    };
    // S = Q K^T: D / 16 k-steps of 16 along d, 4 in each 128-byte slab;
    // descriptors count 16-byte units: k-step kk starts kk % 4 times 32
    // bytes into slab kk / 4
    auto issue_s = [&](float (&sacc)[BK / 2], int t) {
      const uint64_t dk =
          wgmma_desc_sw128(Ks + stage(t) * T::K_BYTES, 16, 1024);
      if constexpr (T::QREG) {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          hopper::wgmma_m64n64k16_rs(
              sacc, qf[kk], dk + (kk / 4) * (KV_SLAB / 16) + 2 * (kk % 4),
              kk > 0);
      } else {
        // the warpgroup's 64 rows of Q, 8 KB into each slab
        const uint64_t dq = wgmma_desc_sw128(Qb + wg * 64 * 128, 16, 1024);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          hopper::wgmma_m64n64k16_ss(
              sacc, dq + (kk / 4) * (Q_SLAB / 16) + 2 * (kk % 4),
              dk + (kk / 4) * (KV_SLAB / 16) + 2 * (kk % 4), kk > 0);
      }
      wgmma_commit();
    };
    // O += P V: V is N-major (its DV columns contiguous), 64-column slabs
    // KV_SLAB apart, 8-key groups 1024 B apart, 16 keys a k-step
    uint32_t pa[BK / 16][4];
    auto issue_pv = [&](int t) {
      const uint64_t dv =
          wgmma_desc_sw128(Vs + stage(t) * T::V_BYTES, KV_SLAB, 1024);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_pv<DV>(o, pa[kk], dv + kk * (16 * 128 / 16));
      wgmma_commit();
    };
    // the online softmax of tile t in place, on rows g (e = 0, 1) and g + 8
    // (e = 2, 3): sacc[4 jt + e] is column 8 jt + 2 c4 + e % 2; masks only
    // where the warp's rows meet one
    auto softmax = [&](float (&sacc)[BK / 2], float (&alpha)[2], int t) {
      const int k0 = (kr.t0 + t) * BK;
      const bool masked = tile_masked(p, q0 + wrow, q0 + wrow + 15, k0, BK);
      float mx[2];
      if (masked) {
#pragma unroll
        for (int e = 0; e < BK / 2; ++e)
          sacc[e] = masked_logit_sel(
              p, sacc[e], scale2, q0 + wrow + g + 8 * ((e % 4) / 2),
              k0 + 8 * (e / 4) + 2 * c4 + e % 2);
      }
      mx[0] = mx[1] = -INFINITY;
#pragma unroll
      for (int e = 0; e < BK / 2; ++e)
        mx[(e % 4) / 2] = fmaxf(mx[(e % 4) / 2], sacc[e]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (!masked) mx[r] *= scale2;  // unmasked logits are unscaled yet
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        mx[r] = fmaxf(mx[r], m[r]);
        alpha[r] = hopper::ex2(m[r] - mx[r]);
        m[r] = mx[r];
        l[r] *= alpha[r];
      }
#pragma unroll
      for (int e = 0; e < BK / 2; ++e) {
        float& x = sacc[e];
        x = hopper::ex2(masked ? x - m[(e % 4) / 2]
                               : fmaf(x, scale2, -m[(e % 4) / 2]));
        l[(e % 4) / 2] += x;
      }
    };
    // O rescaled by alpha (once P V is done with it), P in bf16 as the A
    // fragments of P V, 16 keys a k-step
    auto rescale_and_pack = [&](const float (&sacc)[BK / 2],
                                const float (&alpha)[2]) {
      if (!__all_sync(0xffffffffu, alpha[0] == 1.f && alpha[1] == 1.f)) {
#pragma unroll
        for (int jt = 0; jt < DV / 8; ++jt) {
          o[4 * jt] *= alpha[0];
          o[4 * jt + 1] *= alpha[0];
          o[4 * jt + 2] *= alpha[1];
          o[4 * jt + 3] *= alpha[1];
        }
      }
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const float* s0 = sacc + 8 * kk;
        pa[kk][0] = hopper::pack_bf16(s0[0], s0[1]);
        pa[kk][1] = hopper::pack_bf16(s0[2], s0[3]);
        pa[kk][2] = hopper::pack_bf16(s0[4], s0[5]);
        pa[kk][3] = hopper::pack_bf16(s0[6], s0[7]);
      }
    };

    int ta = 0, tb = kr.nt;
    while (ta < tb && skips(ta)) ++ta;
    while (tb > ta && skips(tb - 1)) --tb;
    for (int t = 0; t < ta; ++t) pass(t);
    if constexpr (T::OVERLAP) {
      if (ta < tb) {
        {
          float sacc[BK / 2], alpha[2];
          mbar_wait(full_k + stage(ta), phase(ta));
          wgmma_fence();
          issue_s(sacc, ta);
          wgmma_wait<0>();
          hopper::fence_regs(sacc);
          release(empty_k + stage(ta));
          softmax(sacc, alpha, ta);
          rescale_and_pack(sacc, alpha);
        }
        for (int t = ta + 1; t < tb; ++t) {
          float sacc[BK / 2], alpha[2];
          mbar_wait(full_k + stage(t), phase(t));
          mbar_wait(full_v + stage(t - 1), phase(t - 1));
          hopper::fence_regs(o);
          wgmma_fence();
          issue_s(sacc, t);
          issue_pv(t - 1);
          wgmma_wait<1>();  // S, the older group, is done; P V may run on
          hopper::fence_regs(sacc);
          release(empty_k + stage(t));
          softmax(sacc, alpha, t);
          wgmma_wait<0>();
          hopper::fence_regs(o);
          release(empty_v + stage(t - 1));
          rescale_and_pack(sacc, alpha);
        }
        mbar_wait(full_v + stage(tb - 1), phase(tb - 1));
        hopper::fence_regs(o);
        wgmma_fence();
        issue_pv(tb - 1);
        wgmma_wait<0>();
        hopper::fence_regs(o);
        release(empty_v + stage(tb - 1));
      }
    } else {
      for (int t = ta; t < tb; ++t) {
        // one product at a time: S, the softmax, P V
        float sacc[BK / 2], alpha[2];
        mbar_wait(full_k + stage(t), phase(t));
        wgmma_fence();
        issue_s(sacc, t);
        wgmma_wait<0>();
        hopper::fence_regs(sacc);
        release(empty_k + stage(t));
        softmax(sacc, alpha, t);
        rescale_and_pack(sacc, alpha);
        mbar_wait(full_v + stage(t), phase(t));
        hopper::fence_regs(o);
        wgmma_fence();
        issue_pv(t);
        wgmma_wait<0>();
        hopper::fence_regs(o);
        release(empty_v + stage(t));
      }
    }
    for (int t = tb; t < kr.nt; ++t) pass(t);
    tg += kr.nt;
    // epilogue: O / l in bf16, staged in this warp's 16 rows of the item's
    // Q buffer (which no product reads any more): columns 64 c .. 64 c + 63
    // in slab c, 16-byte chunks XOR-ed with the row, so that the stores to
    // memory are whole rows
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      l[r] = 1.f / ((l[r] == 0.f) ? 1.f : l[r]);  // the reciprocal from here
    }
    // row g + 8 r of the warp's 16 has (row & 7) == g, so a thread's 16-byte
    // chunk jt % 8 sits at chunk (jt % 8) ^ g in both of its rows
    const uint32_t ostage = hopper::smem_addr(Qb) + wrow * 128;
    const uint32_t mine = ostage + g * 128 + 4 * c4;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
      for (int jt = 0; jt < DV / 8; ++jt)
        hopper::st_shared_b32(
            mine + r * 1024 + (jt / 8) * Q_SLAB + 16 * ((jt % 8) ^ g),
            hopper::pack_bf16(o[4 * jt + 2 * r] * l[r],
                              o[4 * jt + 2 * r + 1] * l[r]));
    }
    __syncwarp();
    bf16* op = static_cast<bf16*>(p.o) + item.b * p.o_sb + item.h * p.o_sh;
    constexpr int CH = DV / 8;    // 16-byte chunks a row
    constexpr int RPR = 32 / CH;  // rows a round of the warp, 16 bytes a lane
#pragma unroll
    for (int k = 0; k < 16 / RPR; ++k) {
      const int row = RPR * k + lane / CH, c = lane % CH;
      const uint4 v = hopper::ld_shared_v4(ostage + (c / 8) * Q_SLAB +
                                           row * 128 +
                                           16 * ((c % 8) ^ (row & 7)));
      if (wrow + row < rows)
        *reinterpret_cast<uint4*>(op + int64_t(q0 + wrow + row) * p.o_ss +
                                  8 * c) = v;
    }
    hopper::fence_proxy_async();  // before TMA loads the next Q here
    __syncwarp();
    if (lane == 0) mbar_arrive(empty_q + qb);
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

template <int D>
cudaError_t launch_f32(const Params& p, cudaStream_t s) {
  using C = F32Tiles<D>;
  static bool ready = false;
  return launch_kernel(flash_f32_kernel<D>, p, C::BQ, 16 * C::TY,
                       f32_smem_bytes<D>(), ready, s);
}

cudaError_t launch_mla_f32(const Params& p, cudaStream_t s) {
  static bool ready = false;
  return launch_kernel(flash_mla_f32_kernel, p, MlaF32::BQ, MlaF32::THREADS,
                       MlaF32::SMEM, ready, s);
}

template <class T>
cudaError_t launch_bf16(const Params& p, cudaStream_t s) {
  static bool ready = false;
  // the epilogue stores whole 16-byte chunks of O's rows
  if (p.o_ss % 8 != 0 || reinterpret_cast<uintptr_t>(p.o) % 16 != 0)
    return cudaErrorInvalidValue;
  const hopper::EncodeTiled encode = hopper::encode_tiled();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  Bf16Args a;
  a.p = p;
  if (!hopper::encode_bf16_map(&a.q, encode, p.q, T::D, p.Sq, p.H, p.B,
                               p.q_ss, p.q_sh, p.q_sb, T::BQ) ||
      !hopper::encode_bf16_map(&a.k, encode, p.k, T::D, p.Sk, p.KH, p.B,
                               p.k_ss, p.k_sh, p.k_sb, T::BK) ||
      !hopper::encode_bf16_map(&a.v, encode, p.v, T::DV, p.Sk, p.KH, p.B,
                               p.v_ss, p.v_sh, p.v_sb, T::BK))
    return cudaErrorInvalidValue;
  cudaError_t err = hopper::set_smem_once(flash_bf16_kernel<T>, T::SMEM, ready);
  int dev = 0, sms = 0, l2 = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&l2, cudaDevAttrL2CacheSize, dev);
  if (err != cudaSuccess) return err;
  // heaviest first where K and V together fit a third of L2, so that
  // reading them in any order reads them from memory once
  const double kv_bytes = 2.0 * p.B * p.KH * p.Sk * (T::D + T::DV);
  a.heavy_first = 3.0 * kv_bytes <= double(l2);
  // one persistent block an SM, at most one a work item
  const int64_t items = int64_t(p.Sq + T::BQ - 1) / T::BQ * p.H * p.B;
  if (items > 0x7fffffff) return cudaErrorInvalidValue;
  const unsigned blocks = unsigned(items < sms ? items : sms);
  flash_bf16_kernel<T><<<blocks, T::THREADS, T::SMEM, s>>>(a);
  return cudaGetLastError();
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
  if (dtype == 0 && D == 64 && Dv == 64) err = launch_f32<64>(p, s);
  else if (dtype == 0 && D == 128 && Dv == 128) err = launch_f32<128>(p, s);
  else if (dtype == 0 && D == 192 && Dv == 128) err = launch_mla_f32(p, s);
  else if (dtype == 0 && D == 256 && Dv == 256) err = launch_f32<256>(p, s);
  else if (dtype == 1 && D == 64 && Dv == 64)
    err = launch_bf16<Bf16Tiles<64, 64>>(p, s);
  else if (dtype == 1 && D == 128 && Dv == 128)
    err = launch_bf16<Bf16Tiles<128, 128>>(p, s);
  else if (dtype == 1 && D == 192 && Dv == 128)
    err = launch_bf16<Bf16Tiles<192, 128>>(p, s);
  else if (dtype == 1 && D == 256 && Dv == 256)
    err = launch_bf16<Bf16Tiles<256, 256>>(p, s);
  return int(err);
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
