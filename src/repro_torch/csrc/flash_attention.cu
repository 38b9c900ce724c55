// Flash-attention forward for Hopper (sm_90a): causal / sliding-window GQA.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (`flash_attention`, body `_kernel`) and computes what it computes:
//   s = (q . k) * scale, masked logits set to -1e30 (causal k <= q with no
//   offset, window k > q - window), an online softmax with the running max,
//   normalizer and accumulator in fp32, and l == 0 -> 1 at the end.
// Inputs are fp32 or bf16, with head dim D in {64, 128, 256}; every
// product is taken in fp32 on the CUDA cores (no TF32, no tensor cores), so
// the fp32 path matches the fp32 reference to rounding.  The output has the
// input's type.
//
// Design.  One thread block owns (batch b, query head h, a tile of BQ query
// rows); the Pallas kernel's sequential k-block grid dimension is the loop
// over key tiles inside the block.  Query head h reads KV head
// h / (H / KH) straight from the un-repeated K/V.  Per key tile:
//   1. the K tile is staged in shared memory (fp32, rows padded by one word
//      so the strided column reads hit distinct banks);
//   2. each of the 256 threads computes a 4x4 block of S = Q K^T;
//   3. one warp per row runs the online-softmax update on S in shared
//      memory (m, l and the rescale factor alpha live in shared memory);
//   4. the V tile replaces K in the same buffer and each thread adds its
//      4 x (D/16) block of P V into registers.
// The accumulator stays in fp32 registers for the whole key loop: 4 x D/16
// floats a thread, 64 at D = 256.  Dynamic shared memory is
// 4 (64 (D+1) + 64 (D+1) + 64 x 65 + 192) bytes: 50 KB at D = 64, 83 KB at
// D = 128 and 149 KB at D = 256, under the 227 KB a block may have; launch()
// opts in above 48 KB.
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
// Columns past Sk in a ragged last tile are -inf, so they add nothing.
//
// Bound on an H100 SXM.  Prefill of Qwen2-1.5B at B=4, H=12, KV=2, S=512,
// D=128, causal: ~3.2 GFLOP over ~29 MB of q/k/v/o in fp32.  At 67 TFLOP/s
// fp32 (CUDA cores) and 3.35 TB/s that is ~48 us of arithmetic against
// ~9 us of memory, so fp32 without tensor cores is compute-bound.  With
// bf16 inputs the card's bound is the tensor cores' 989 TFLOP/s, which
// makes the same work memory-bound (~4 us); this kernel still computes
// bf16 in fp32 on the CUDA cores and is far from that bound.  The
// RecurrentGemma-9B prefill (B=4, H=16, KV=1, S=512, D=256, causal, window
// 2048, so the window never bites) is ~8.6 GFLOP against ~71 MB: ~0.13 ms
// by operations in fp32.  This first kernel is simple and right:
// shared-memory reads feed the FMAs, and wgmma / TMA / warp specialisation
// are later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libflash_attention.so flash_attention.cu

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per tile
constexpr int THREADS = 256;  // 16 x 16 thread grid over the tiles
constexpr int WARPS = THREADS / 32;
constexpr float MASKED = -1e30f;  // the Pallas kernel's NEG_INF

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int64_t q_sb, q_sh, q_ss;  // strides in elements; the last dim is unit
  int64_t k_sb, k_sh, k_ss;
  int64_t v_sb, v_sh, v_ss;
  int64_t o_sb, o_sh, o_ss;
  int H, KH, Sq, Sk;
  int causal;
  int window;  // > 0: keys k > q - window are visible; <= 0: no window
  float scale;
};

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (size_t(BQ) * (D + 1) + size_t(BK) * (D + 1) + size_t(BQ) * (BK + 1) +
          3 * BQ);
}

// Stage rows [row0, row0 + nrows) of a (rows, D) slab with row stride `ld_g`
// into a BR x (D + 1) fp32 tile; rows past nrows are zero.
template <typename T, int D, int BR>
__device__ __forceinline__ void stage_tile(float* dst, const T* src,
                                           int64_t ld_g, int row0, int nrows) {
  constexpr int LD = D + 1;
  for (int i = threadIdx.x; i < BR * D; i += THREADS) {
    const int r = i / D, d = i % D;
    dst[r * LD + d] =
        r < nrows ? load_f32(src + int64_t(row0 + r) * ld_g + d) : 0.f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    flash_fwd_kernel(const Params p) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int LD = D + 1;
  constexpr int LDS = BK + 1;
  constexpr int DJ = D / 16;  // output columns per thread

  extern __shared__ float smem[];
  float* Qs = smem;             // BQ x LD
  float* KVs = Qs + BQ * LD;    // BK x LD: the K tile, then the V tile
  float* Ss = KVs + BK * LD;    // BQ x LDS: logits, then probabilities
  float* m_s = Ss + BQ * LDS;   // running max
  float* l_s = m_s + BQ;        // running normalizer
  float* a_s = l_s + BQ;        // this tile's rescale factor alpha

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int lane = tid % 32, warp = tid / 32;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.H / p.KH);

  const T* qp = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kp = static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const T* vp = static_cast<const T*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  T* op = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;

  const int rows = min(BQ, p.Sq - q0);
  stage_tile<T, D, BQ>(Qs, qp, p.q_ss, q0, rows);
  for (int r = tid; r < BQ; r += THREADS) {
    m_s[r] = MASKED;
    l_s[r] = 0.f;
  }

  // Keys [lo, hi) hold every visible key of every row of this tile.
  const bool windowed = p.window > 0;
  const int qlast = q0 + rows - 1;
  int lo = windowed ? max(0, q0 - p.window + 1) : 0;
  int hi = p.causal ? min(p.Sk, qlast + 1) : p.Sk;
  const int last_lo = windowed ? max(0, qlast - p.window + 1) : 0;
  if (last_lo >= hi) {  // the last row sees no key: walk all keys
    lo = 0;
    hi = p.Sk;
  }

  float acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  for (int k0 = (lo / BK) * BK; k0 < hi; k0 += BK) {
    const int kcols = min(BK, p.Sk - k0);
    __syncthreads();  // the last tile's P V reads are done
    stage_tile<T, D, BK>(KVs, kp, p.k_ss, k0, kcols);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 16
    for (int d = 0; d < D; ++d) {
      float a[4], bk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) bk[j] = KVs[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i, qi = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j, ki = k0 + c;
        float x = s[i][j] * p.scale;
        if (c >= kcols)
          x = -INFINITY;
        else if ((p.causal && ki > qi) || (windowed && ki <= qi - p.window))
          x = MASKED;
        Ss[r * LDS + c] = x;
      }
    }
    __syncthreads();  // S is complete and the K tile is no longer read

    stage_tile<T, D, BK>(KVs, vp, p.v_ss, k0, kcols);
    for (int r = warp; r < BQ; r += WARPS) {
      const float x0 = Ss[r * LDS + lane], x1 = Ss[r * LDS + lane + 32];
      float mx = fmaxf(x0, x1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      const float p0 = expf(x0 - m_new), p1 = expf(x1 - m_new);
      Ss[r * LDS + lane] = p0;
      Ss[r * LDS + lane + 32] = p1;
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();  // P, alpha and the V tile are ready

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float alpha = a_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
    }
#pragma unroll 8
    for (int c = 0; c < BK; ++c) {
      float pr[4], vv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pr[i] = Ss[(ty + 16 * i) * LDS + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = KVs[c * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(pr[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r < rows) {
      float l = l_s[r];
      l = (l == 0.f) ? 1.f : l;
      T* orow = op + int64_t(q0 + r) * p.o_ss;
#pragma unroll
      for (int j = 0; j < DJ; ++j) store_f32(orow + tx + 16 * j, acc[i][j] / l);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const Params& p, dim3 grid, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return err;
  flash_fwd_kernel<T, D><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements.  Returns a
// cudaError_t code; 0 means the launch was accepted.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int64_t q_sb,
    int64_t q_sh, int64_t q_ss, int64_t k_sb, int64_t k_sh, int64_t k_ss,
    int64_t v_sb, int64_t v_sh, int64_t v_ss, int64_t o_sb, int64_t o_sh,
    int64_t o_ss, int B, int H, int KH, int Sq, int Sk, int D, int causal,
    int window, int dtype, float scale, void* stream) {
  if (B <= 0 || H <= 0 || KH <= 0 || H % KH != 0 || Sq <= 0 || Sk <= 0 ||
      H > 65535 || B > 65535)
    return int(cudaErrorInvalidValue);
  Params p{q,    k,    v,    o,    q_sb,   q_sh,   q_ss,   k_sb,
           k_sh, k_ss, v_sb, v_sh, v_ss,   o_sb,   o_sh,   o_ss,
           H,    KH,   Sq,   Sk,   causal, window, scale};
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0 && D == 64) err = launch<float, 64>(p, grid, s);
  else if (dtype == 0 && D == 128) err = launch<float, 128>(p, grid, s);
  else if (dtype == 1 && D == 64) err = launch<__nv_bfloat16, 64>(p, grid, s);
  else if (dtype == 1 && D == 128) err = launch<__nv_bfloat16, 128>(p, grid, s);
  else if (dtype == 0 && D == 256) err = launch<float, 256>(p, grid, s);
  else if (dtype == 1 && D == 256) err = launch<__nv_bfloat16, 256>(p, grid, s);
  return int(err);
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
