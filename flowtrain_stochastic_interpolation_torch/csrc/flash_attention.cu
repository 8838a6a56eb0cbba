// Flash attention, forward (K3), written by hand for Hopper (sm_90a), with a
// plain C interface bound from Python through ctypes
// (flowtrain_stochastic_interpolation_torch/ops/flash_attention.py).
//
// Replaces flowtrain_stochastic_interpolation_tpu/ops/flash_attention.py
// _fa_kernel (called from _flash_fwd_bhnd): non-causal softmax attention with
// scale d^-1/2 over flattened voxel tokens,
//     s = q k^T * d^-1/2,   out = softmax(s) v,   lse = logsumexp(s)
// for one (batch, head) per blockIdx.y. q is [B, N, h, d] and k, v are
// [B, M, h, d], each read in place through its batch, token and head strides
// (q is a column slice of the UNet's [B, N, 3, h, d] projection; k and v are
// the caller's concatenation of the memory tokens and the keys), bf16 or
// f32, with any head width d that is a multiple of 8. out is [B, N, h, d] in
// the operands' dtype, contiguous; lse is [B, h, N] f32.
//
// bf16 operands at d <= 128 (every main path) take flash_mma, the tensor-core
// kernel; f32 operands take flash_forward<float, D>, and d > 128 flash_wide,
// both on the FP32 cores (further down).
//
// Numerics. Key columns past M are masked to -inf and their rows are never
// read; query rows past N are never written. Every key tile the loop visits
// holds at least one real key, so the running max is finite after the first
// tile and exp(m_prev - m_new) never sees -inf - (-inf). The running max, sum
// and accumulator are f32.
//   * flash_mma: the scores are mma.sync products of bf16 values, exact in
//     f32, summed in f32 as in the TPU kernel (only the order differs); the
//     softmax runs in base 2 (exp2 with d^-1/2 log2 e folded into the scale,
//     lse = (m + log2 l) ln 2) and its sum is taken from the unrounded f32 p.
//     p then enters the second product as two bf16 terms, p = p_hi + p_lo
//     (p_hi = bf16(p), p_lo = bf16(p - p_hi)), each multiplied by v on the
//     tensor cores: that carries p to about 2^-16, near f32. bf16 p alone
//     (2^-9) misses the kernel's tolerance against its f32 plain version at
//     the fa16 shape, and the second product costs little in a kernel bound
//     by its exponentials.
//   * flash_forward<float, D> and flash_wide: scores, p and p.v in f32 on the
//     FP32 cores (bf16 operands of flash_wide are upcast exactly).
//
// Bounds on the H100 at the fa16 stage (b8 x 4096 queries x 4100 keys x 4
// heads x 32): the two products are 4 BH N M d = 6.9e10 operations, 0.070 ms
// at the 989 TFLOP/s of the bf16 tensor cores; q, k, v, out and lse are about
// 34 MB, 0.010 ms at 3.35 TB/s; and the softmax takes BH N M = 5.4e8
// exponentials, 0.138 ms at the special-function units' 16 per SM per clock
// (3.9e12 per second on 132 SMs). So the kernel is bound by its exponentials,
// at d = 32 well before the tensor cores.
//
// What flash_mma does about it (the FlashAttention-2 form on mma.sync): each
// warp owns 16 query rows (two tiles of 16 at d <= 32) and keeps their Q
// fragments in registers; K and V tiles of 64 keys stream through a ring of
// shared-memory stages filled by cp.async, so copies overlap the products;
// both products run on the tensor cores (m16n8k16, K and V fragments through
// ldmatrix and ldmatrix.trans, V being key-major), P goes from the score
// accumulators to A fragments in registers and never through shared memory,
// and one exp2 per score is all the special-function work beside one rescale
// per row and tile. The FP32 cores keep the scale, max, sum and the split of
// p. -Xptxas -v: flash_mma<32 / 64 / 128> use 164 / 127 / 166 registers and
// spill nothing. On the card (tools/ab_flash_attention.py) dropping the p_lo
// product saves a fifth of the time and dropping the exponential a tenth: at
// d = 32 the mma.sync instruction rate and the latency of each tile's chain (scores,
// max, exp2, p.v) hold it, not the special-function units; overlapping one
// tile's softmax with the next tile's products (wgmma, asynchronous) is the
// next step.
//
// flash_forward<float, D> is the first, exact version: each thread owns one
// query row (q and its f32 accumulator in registers; at d > 64 four threads
// share a row), each block walks all key tiles of its (batch, head), staging
// KT keys and values at a time in shared memory. A head wider than 128 takes
// flash_wide: the scores accumulate over d in chunks staged in shared memory,
// and each block owns a 128-wide tile of the output columns and recomputes the
// scores for it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_async.cuh"

namespace {

// flash_forward (f32 operands). Head widths come in three buckets with the
// actual d (a multiple of 8) masked at run time: q, k and v columns at or past
// d are zero, and out columns past d are never written. Up to 64 one thread owns a whole query
// row (q and its f32 accumulator in registers); at 128 a row is split over 4
// neighbouring threads, each holding every 4th group of 4 columns, which
// sum their partial scores with warp shuffles, so no thread holds more than
// 64 values of q and the accumulator and nothing spills.
template <int D>
struct FlashShape {
  static constexpr int SPLIT = D <= 64 ? 1 : 4;          // threads per query row
  static constexpr int COLS = D / SPLIT;                 // columns a thread holds
  static constexpr int THREADS = D <= 64 ? 128 : 256;
  static constexpr int ROWS = THREADS / SPLIT;           // query rows per block: 128, 128, 64
  // keys staged in shared memory per step: the tile's scores live in
  // registers beside q and the accumulator, so wider heads take shorter tiles
  static constexpr int KT = D <= 32 ? 64 : 32;
};

__device__ __forceinline__ void load8(const float* p, float* f) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* f) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float2 a = __bfloat1622float2(h2[0]);
  const float2 b = __bfloat1622float2(h2[1]);
  f[0] = a.x; f[1] = a.y; f[2] = b.x; f[3] = b.y;
}
__device__ __forceinline__ void load4(const float* p, float* f) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* f) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(f[0], f[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(f[2], f[3]);
  uint2 packed;
  packed.x = *reinterpret_cast<const uint32_t*>(&lo);
  packed.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = packed;
}
__device__ __forceinline__ void store4(float* p, const float* f) {
  *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
}

template <typename T, int D>
__global__ void __launch_bounds__(FlashShape<D>::THREADS)
flash_forward(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              long long q_bs, long long q_ts, long long q_hs,
              long long k_bs, long long k_ts, long long k_hs,
              long long v_bs, long long v_ts, long long v_hs,
              T* __restrict__ out, float* __restrict__ lse,
              int heads, int n, int m, int d, float scale) {
  using S = FlashShape<D>;
  constexpr int KT = S::KT, GROUPS = S::COLS / 4;
  const int t = threadIdx.x;
  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const int row = blockIdx.x * S::ROWS + t / S::SPLIT;
  const int part = t % S::SPLIT;
  const bool live = row < n;
  // column of the first element of this thread's g-th group of 4
  auto column = [part](int g) { return 4 * (part + S::SPLIT * g); };

  __shared__ __align__(16) float k_s[KT][D];
  __shared__ __align__(16) float v_s[KT][D];

  float qr[S::COLS];
  const T* qp = q + b * q_bs + (long long)row * q_ts + h * q_hs;
#pragma unroll
  for (int g = 0; g < GROUPS; ++g) {
    if (live && column(g) < d) {
      load4(qp + column(g), qr + 4 * g);
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c) qr[4 * g + c] = 0.f;
    }
  }

  const T* kb = k + b * k_bs + h * k_hs;
  const T* vb = v + b * v_bs + h * v_hs;

  float acc[S::COLS];
#pragma unroll
  for (int c = 0; c < S::COLS; ++c) acc[c] = 0.f;
  float m_run = -INFINITY, l_run = 0.f;

  for (int base = 0; base < m; base += KT) {
    const int rows = min(KT, m - base);
    __syncthreads();  // the previous tile is consumed
    // rows past M and columns past d are filled with zeros (the rows are
    // masked below); never read from memory
    for (int i = t; i < KT * D / 8; i += S::THREADS) {
      const int r = i / (D / 8), c8 = (i % (D / 8)) * 8;
      float kf[8], vf[8];
      if (r < rows && c8 < d) {
        load8(kb + (long long)(base + r) * k_ts + c8, kf);
        load8(vb + (long long)(base + r) * v_ts + c8, vf);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) kf[j] = vf[j] = 0.f;
      }
      float4* kd = reinterpret_cast<float4*>(&k_s[r][c8]);
      float4* vd = reinterpret_cast<float4*>(&v_s[r][c8]);
      kd[0] = make_float4(kf[0], kf[1], kf[2], kf[3]);
      kd[1] = make_float4(kf[4], kf[5], kf[6], kf[7]);
      vd[0] = make_float4(vf[0], vf[1], vf[2], vf[3]);
      vd[1] = make_float4(vf[4], vf[5], vf[6], vf[7]);
    }
    __syncthreads();

    float s[KT];
    float tile_max = -INFINITY;
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int g = 0; g < GROUPS; ++g) {
        const float4 kk = *reinterpret_cast<const float4*>(&k_s[j][column(g)]);
        dot = fmaf(qr[4 * g], kk.x, dot);
        dot = fmaf(qr[4 * g + 1], kk.y, dot);
        dot = fmaf(qr[4 * g + 2], kk.z, dot);
        dot = fmaf(qr[4 * g + 3], kk.w, dot);
      }
#pragma unroll
      for (int off = 1; off < S::SPLIT; off <<= 1) dot += __shfl_xor_sync(0xffffffffu, dot, off);
      s[j] = (j < rows) ? dot * scale : -INFINITY;
      tile_max = fmaxf(tile_max, s[j]);
    }
    const float m_new = fmaxf(m_run, tile_max);  // finite: the tile has a real key
    const float alpha = expf(m_run - m_new);     // 0 on the first tile
    l_run *= alpha;
#pragma unroll
    for (int c = 0; c < S::COLS; ++c) acc[c] *= alpha;
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      const float p = expf(s[j] - m_new);  // 0 for the masked columns
      l_run += p;
#pragma unroll
      for (int g = 0; g < GROUPS; ++g) {
        const float4 vv = *reinterpret_cast<const float4*>(&v_s[j][column(g)]);
        acc[4 * g] = fmaf(p, vv.x, acc[4 * g]);
        acc[4 * g + 1] = fmaf(p, vv.y, acc[4 * g + 1]);
        acc[4 * g + 2] = fmaf(p, vv.z, acc[4 * g + 2]);
        acc[4 * g + 3] = fmaf(p, vv.w, acc[4 * g + 3]);
      }
    }
    m_run = m_new;
  }

  if (!live) return;
  T* op = out + (((long long)b * n + row) * heads + h) * d;
#pragma unroll
  for (int g = 0; g < GROUPS; ++g) {
    if (column(g) >= d) continue;
    float o[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) o[c] = acc[4 * g + c] / l_run;
    store4(op + column(g), o);
  }
  if (part == 0) lse[(long long)bh * n + row] = m_run + logf(l_run);
}

// ---------------------------------------------------------------------------
// d > 128: one block per (64 query rows, batch*head, 128-wide output column
// tile). Four neighbouring threads share a query row: for each tile of 64
// keys they accumulate the full-width scores over d in chunks of 64 columns
// of q and k staged in shared memory (each thread 16 keys of its row), take
// the online softmax over the tile with shuffles among the four, and then
// multiply p (through shared memory) by the tile's [64, 128] slice of v, each
// thread holding 32 of the row's 128 accumulator columns. Every column tile
// recomputes the same scores in the same order, so their maxima and sums
// agree; tile 0 writes lse. Shared memory: 82 KB, dynamic.
// ---------------------------------------------------------------------------
constexpr int FW_ROWS = 64, FW_KT = 64, FW_DC = 64, FW_COLS = 128, FW_THREADS = 256;
constexpr int FW_SMEM = (FW_ROWS * (FW_DC + 1) + FW_KT * (FW_DC + 1) + FW_KT * FW_COLS +
                         FW_ROWS * (FW_KT + 1)) * 4;

template <typename T>
__global__ void __launch_bounds__(FW_THREADS)
flash_wide(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           long long q_bs, long long q_ts, long long q_hs,
           long long k_bs, long long k_ts, long long k_hs,
           long long v_bs, long long v_ts, long long v_hs,
           T* __restrict__ out, float* __restrict__ lse,
           int heads, int n, int m, int d, float scale) {
  const int t = threadIdx.x;
  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const int row0 = blockIdx.x * FW_ROWS, col0 = blockIdx.z * FW_COLS;
  const int r = t >> 2, part = t & 3, row = row0 + r;
  constexpr int KEYS = FW_KT / 4, GROUPS = FW_COLS / 16;  // per thread: keys, groups of 4 columns
  // this thread's g-th group of 4 output columns, relative to col0
  auto column = [part](int g) { return 4 * (part + 4 * g); };

  extern __shared__ __align__(16) float smem[];
  float (*q_s)[FW_DC + 1] = reinterpret_cast<float (*)[FW_DC + 1]>(smem);
  float (*k_s)[FW_DC + 1] = reinterpret_cast<float (*)[FW_DC + 1]>(smem + FW_ROWS * (FW_DC + 1));
  float (*v_s)[FW_COLS] = reinterpret_cast<float (*)[FW_COLS]>(
      smem + (FW_ROWS + FW_KT) * (FW_DC + 1));
  float (*p_s)[FW_KT + 1] = reinterpret_cast<float (*)[FW_KT + 1]>(
      smem + (FW_ROWS + FW_KT) * (FW_DC + 1) + FW_KT * FW_COLS);

  const T* qb = q + b * q_bs + h * q_hs;
  const T* kb = k + b * k_bs + h * k_hs;
  const T* vb = v + b * v_bs + h * v_hs;

  float acc[4 * GROUPS];
#pragma unroll
  for (int c = 0; c < 4 * GROUPS; ++c) acc[c] = 0.f;
  float m_run = -INFINITY, l_run = 0.f;

  for (int base = 0; base < m; base += FW_KT) {
    const int rows = min(FW_KT, m - base);
    float s[KEYS];
#pragma unroll
    for (int j = 0; j < KEYS; ++j) s[j] = 0.f;
    for (int dc = 0; dc < d; dc += FW_DC) {
      __syncthreads();  // the previous chunk (and the previous key tile) is consumed
      // query rows past n, keys past m and columns past d are zeros, never read
      for (int i = t; i < (FW_ROWS + FW_KT) * FW_DC / 4; i += FW_THREADS) {
        const int rr = i / (FW_DC / 4) % FW_ROWS, c4 = (i % (FW_DC / 4)) * 4;
        const bool is_q = i < FW_ROWS * FW_DC / 4;
        float f[4] = {0.f, 0.f, 0.f, 0.f};
        if (dc + c4 < d) {
          if (is_q && row0 + rr < n) load4(qb + (long long)(row0 + rr) * q_ts + dc + c4, f);
          if (!is_q && rr < rows) load4(kb + (long long)(base + rr) * k_ts + dc + c4, f);
        }
        float* dst = is_q ? &q_s[rr][c4] : &k_s[rr][c4];
#pragma unroll
        for (int c = 0; c < 4; ++c) dst[c] = f[c];
      }
      __syncthreads();
      for (int c = 0; c < FW_DC; ++c) {
        const float qv = q_s[r][c];
#pragma unroll
        for (int j = 0; j < KEYS; ++j) s[j] = fmaf(qv, k_s[part + 4 * j][c], s[j]);
      }
    }
    float tile_max = -INFINITY;
#pragma unroll
    for (int j = 0; j < KEYS; ++j) {
      s[j] = (part + 4 * j < rows) ? s[j] * scale : -INFINITY;
      tile_max = fmaxf(tile_max, s[j]);
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, off));
    const float m_new = fmaxf(m_run, tile_max);  // finite: the tile has a real key
    const float alpha = expf(m_run - m_new);     // 0 on the first tile
    float tile_sum = 0.f;
#pragma unroll
    for (int j = 0; j < KEYS; ++j) {
      const float p = expf(s[j] - m_new);  // 0 for the masked keys
      tile_sum += p;
      p_s[r][part + 4 * j] = p;
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) tile_sum += __shfl_xor_sync(0xffffffffu, tile_sum, off);
    l_run = l_run * alpha + tile_sum;
#pragma unroll
    for (int c = 0; c < 4 * GROUPS; ++c) acc[c] *= alpha;
    for (int i = t; i < FW_KT * FW_COLS / 4; i += FW_THREADS) {
      const int j = i / (FW_COLS / 4), c4 = (i % (FW_COLS / 4)) * 4;
      float f[4] = {0.f, 0.f, 0.f, 0.f};
      if (j < rows && col0 + c4 < d) load4(vb + (long long)(base + j) * v_ts + col0 + c4, f);
      *reinterpret_cast<float4*>(&v_s[j][c4]) = make_float4(f[0], f[1], f[2], f[3]);
    }
    __syncthreads();
    for (int j = 0; j < FW_KT; ++j) {
      const float p = p_s[r][j];
#pragma unroll
      for (int g = 0; g < GROUPS; ++g) {
        const float4 vv = *reinterpret_cast<const float4*>(&v_s[j][column(g)]);
        acc[4 * g] = fmaf(p, vv.x, acc[4 * g]);
        acc[4 * g + 1] = fmaf(p, vv.y, acc[4 * g + 1]);
        acc[4 * g + 2] = fmaf(p, vv.z, acc[4 * g + 2]);
        acc[4 * g + 3] = fmaf(p, vv.w, acc[4 * g + 3]);
      }
    }
    m_run = m_new;
  }

  if (row >= n) return;
  T* op = out + (((long long)b * n + row) * heads + h) * d + col0;
#pragma unroll
  for (int g = 0; g < GROUPS; ++g) {
    if (col0 + column(g) >= d) continue;
    float o[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) o[c] = acc[4 * g + c] / l_run;
    store4(op + column(g), o);
  }
  if (blockIdx.z == 0 && part == 0) lse[(long long)bh * n + row] = m_run + logf(l_run);
}

template <typename T>
int launch_wide(const void* q, const void* k, const void* v, long long q_bs, long long q_ts,
                long long q_hs, long long k_bs, long long k_ts, long long k_hs, long long v_bs,
                long long v_ts, long long v_hs, void* out, void* lse, int batch, int heads,
                int n, int m, int d, float scale, cudaStream_t s) {
  static bool sized = false;  // above 48 KB only once the kernel is allowed to
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_wide<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, FW_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    sized = true;
  }
  const dim3 grid((n + FW_ROWS - 1) / FW_ROWS, batch * heads, (d + FW_COLS - 1) / FW_COLS);
  flash_wide<T><<<grid, FW_THREADS, FW_SMEM, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), q_bs, q_ts,
      q_hs, k_bs, k_ts, k_hs, v_bs, v_ts, v_hs, static_cast<T*>(out), static_cast<float*>(lse),
      heads, n, m, d, scale);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16 at d <= 128: the tensor-core kernel. One block per (ROWS query rows,
// batch*head); each warp owns MT tiles of 16 query rows and keeps their Q
// fragments in registers for the whole key loop, and every K and V fragment
// it loads serves its MT row tiles. Key and value tiles of KT = 64 keys stream
// through a ring of STAGES shared-memory buffers filled by 16-byte cp.async
// (zeros past m and past d), so the copy of tile i + STAGES - 1 overlaps the
// products of tile i. Rows of every staged tile are padded by 8 elements (16
// bytes): the eight rows an ldmatrix reads at once then fall in eight
// different 16-byte bank groups.
// ---------------------------------------------------------------------------
template <int D>
struct MmaShape {
  static constexpr int MT = D <= 32 ? 2 : 1;  // 16-row tiles per warp
  static constexpr int WARPS = 4;
  static constexpr int STAGES = D <= 64 ? 3 : 2;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int ROWS = 16 * MT * WARPS;  // query rows per block
  static constexpr int KT = 64;                 // keys per tile
  static constexpr int LD = D + 8;              // padded row of a staged tile, in elements
  static constexpr int SMEM = (ROWS + 2 * STAGES * KT) * LD * 2;
};

constexpr float LN2 = 0.69314718055994531f;

template <int D>
__global__ void __launch_bounds__(MmaShape<D>::THREADS)
flash_mma(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
          const __nv_bfloat16* __restrict__ v, long long q_bs, long long q_ts, long long q_hs,
          long long k_bs, long long k_ts, long long k_hs, long long v_bs, long long v_ts,
          long long v_hs, __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int heads,
          int n, int m, int d, float scale_log2) {
  using S = MmaShape<D>;
  using namespace mma_async;
  constexpr int KT = S::KT, LD = S::LD, STAGES = S::STAGES, MT = S::MT, CH = D / 8, NT = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [ROWS][LD]
  __nv_bfloat16* kv_s = q_s + S::ROWS * LD;  // STAGES x (K [KT][LD], V [KT][LD])

  const int t = threadIdx.x, warp = t >> 5, lane = t & 31, g = lane >> 2, qd = lane & 3;
  const int mi = lane >> 3, mr = lane & 7;  // this lane's ldmatrix matrix and row
  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const int row0 = blockIdx.x * S::ROWS;
  const __nv_bfloat16* qb = q + b * q_bs + h * q_hs;
  const __nv_bfloat16* kb = k + b * k_bs + h * k_hs;
  const __nv_bfloat16* vb = v + b * v_bs + h * v_hs;
  const int chunks = d / 8;  // 16-byte chunks of a row that hold data
  const int tiles = (m + KT - 1) / KT;

  for (int i = t; i < S::ROWS * CH; i += S::THREADS) {
    const int r = i / CH, c = i % CH;
    const bool ok = row0 + r < n && c < chunks;
    cp_async16(q_s + r * LD + 8 * c, ok ? qb + (row0 + r) * q_ts + 8 * c : qb, ok);
  }
  auto stage = [&](int tile) {
    __nv_bfloat16* ks = kv_s + (tile % STAGES) * 2 * KT * LD;
    __nv_bfloat16* vs = ks + KT * LD;
    const int base = tile * KT;
    for (int i = t; i < KT * CH; i += S::THREADS) {
      const int r = i / CH, c = i % CH;
      const bool ok = base + r < m && c < chunks;
      cp_async16(ks + r * LD + 8 * c, ok ? kb + (base + r) * k_ts + 8 * c : kb, ok);
      cp_async16(vs + r * LD + 8 * c, ok ? vb + (base + r) * v_ts + 8 * c : vb, ok);
    }
  };
  // group 0: Q and tile 0; then one group per tile, empty past the last
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < tiles) stage(st);
    cp_async_commit();
  }

  // per row tile mt: Q fragments, output accumulators, and the running max
  // and sum of rows g and g + 8 (index 2 mt + r)
  uint32_t qf[MT][D / 16][4];
  float o[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[mt][j][e] = 0.f;
  float m_run[2 * MT], l_run[2 * MT];
#pragma unroll
  for (int r = 0; r < 2 * MT; ++r) {
    m_run[r] = -INFINITY;
    l_run[r] = 0.f;
  }

  for (int it = 0; it < tiles; ++it) {
    cp_async_wait<STAGES - 2>();  // tile it (and, at it = 0, Q) has landed
    __syncthreads();              // ... for every thread, and tile it - 1 is consumed
    if (it == 0) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int ks = 0; ks < D / 16; ++ks)
          ldmatrix_x4(qf[mt][ks], q_s + ((warp * MT + mt) * 16 + (mi & 1) * 8 + mr) * LD +
                                      16 * ks + (mi >> 1) * 8);
    }
    if (it + STAGES - 1 < tiles) stage(it + STAGES - 1);
    cp_async_commit();
    const __nv_bfloat16* k_t = kv_s + (it % STAGES) * 2 * KT * LD;
    const __nv_bfloat16* v_t = k_t + KT * LD;

    // S = Q K^T for the tile's 64 keys: 8 n-tiles of 8 keys per row tile
    float s[MT][KT / 8][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < KT / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mt][j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      if (16 * ks >= d) break;  // the columns past d are zero: skip their k-steps
#pragma unroll
      for (int np = 0; np < KT / 16; ++np) {
        uint32_t kf[4];
        ldmatrix_x4(kf, k_t + (16 * np + (mi >> 1) * 8 + mr) * LD + 16 * ks + (mi & 1) * 8);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma(s[mt][2 * np], qf[mt][ks], kf[0], kf[1]);
          mma(s[mt][2 * np + 1], qf[mt][ks], kf[2], kf[3]);
        }
      }
    }

    // online softmax in base 2: scores scaled by d^-1/2 log2(e) (> 0, so the
    // max of the raw scores scales to the max of the scaled ones), keys past m
    // at -inf (only the last tile has any)
    const int valid = m - it * KT;  // >= 1: every tile holds a real key
    if (valid < KT) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < KT / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (8 * j + 2 * qd + (e & 1) >= valid) s[mt][j][e] = -INFINITY;
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < KT / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[mt][j][e]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m_run[2 * mt + r], mx[r] * scale_log2);
        const float alpha = exp2_approx(m_run[2 * mt + r] - m_new);  // 0 on the first tile
        l_run[2 * mt + r] *= alpha;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          o[mt][j][2 * r] *= alpha;
          o[mt][j][2 * r + 1] *= alpha;
        }
        m_run[2 * mt + r] = m_new;
      }
#pragma unroll
      for (int j = 0; j < KT / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          // 0 for the masked keys
          const float p = exp2_approx(fmaf(s[mt][j][e], scale_log2, -m_run[2 * mt + (e >> 1)]));
          s[mt][j][e] = p;
          l_run[2 * mt + (e >> 1)] += p;  // this lane's columns; the quad's sum is taken at the end
        }
    }

    // O += P V. Two n8 tiles of S are one k16 A fragment of P, so P stays in
    // registers; P = P_hi + P_lo, both bf16, two products (near-f32 P).
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) {
      uint32_t hi[MT][4], lo[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          const float* c = &s[mt][2 * kk + (f >> 1)][2 * (f & 1)];
          hi[mt][f] = pack_bf16(c[0], c[1]);
          lo[mt][f] = pack_bf16(c[0] - low_f32(hi[mt][f]), c[1] - high_f32(hi[mt][f]));
        }
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        if (16 * np >= d) break;
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, v_t + (16 * kk + (mi & 1) * 8 + mr) * LD + 16 * np + (mi >> 1) * 8);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma(o[mt][2 * np], hi[mt], vf[0], vf[1]);
          mma(o[mt][2 * np], lo[mt], vf[0], vf[1]);
          mma(o[mt][2 * np + 1], hi[mt], vf[2], vf[3]);
          mma(o[mt][2 * np + 1], lo[mt], vf[2], vf[3]);
        }
      }
    }
  }
  cp_async_wait<0>();  // no copy outlives the block

#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = l_run[2 * mt + r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const int row = row0 + (warp * MT + mt) * 16 + g + 8 * r;
      if (row >= n) continue;
      const float inv = 1.f / l;
      __nv_bfloat16* op = out + (((long long)b * n + row) * heads + h) * d;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int col = 8 * j + 2 * qd;
        if (col < d)
          *reinterpret_cast<uint32_t*>(op + col) =
              pack_bf16(o[mt][j][2 * r] * inv, o[mt][j][2 * r + 1] * inv);
      }
      if (qd == 0) lse[(long long)bh * n + row] = (m_run[2 * mt + r] + log2f(l)) * LN2;
    }
}

template <int D>
int launch_mma(const void* q, const void* k, const void* v, long long q_bs, long long q_ts,
               long long q_hs, long long k_bs, long long k_ts, long long k_hs, long long v_bs,
               long long v_ts, long long v_hs, void* out, void* lse, int batch, int heads, int n,
               int m, int d, float scale, cudaStream_t s) {
  using S = MmaShape<D>;
  static bool sized = false;  // above 48 KB only once the kernel is allowed to
  if (!sized) {
    const cudaError_t err =
        cudaFuncSetAttribute(flash_mma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    sized = true;
  }
  const dim3 grid((n + S::ROWS - 1) / S::ROWS, batch * heads);
  flash_mma<D><<<grid, S::THREADS, S::SMEM, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), q_bs, q_ts, q_hs, k_bs, k_ts, k_hs, v_bs, v_ts, v_hs,
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse), heads, n, m, d,
      scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, long long q_bs, long long q_ts,
           long long q_hs, long long k_bs, long long k_ts, long long k_hs, long long v_bs,
           long long v_ts, long long v_hs, void* out, void* lse, int batch, int heads,
           int n, int m, int d, float scale, cudaStream_t s) {
  using S = FlashShape<D>;
  const dim3 grid((n + S::ROWS - 1) / S::ROWS, batch * heads);
  flash_forward<T, D><<<grid, S::THREADS, 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), q_bs, q_ts,
      q_hs, k_bs, k_ts, k_hs, v_bs, v_ts, v_hs, static_cast<T*>(out), static_cast<float*>(lse),
      heads, n, m, d, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// K3: out [batch, n, heads, d] (contiguous, in the operands' dtype) and lse
// [batch, heads, n] f32 from q [batch, n, heads, d] and k, v [batch, m,
// heads, d], all bf16 (is_f32 == 0) or all f32, each given by its batch,
// token and head strides in elements (d contiguous, every row 16-byte
// aligned). d is a multiple of 8 (above 128, flash_wide); n >= 1 and m >= 1.
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// another d.
int flash_attention_forward(const void* q, const void* k, const void* v, long long q_bs,
                            long long q_ts, long long q_hs, long long k_bs, long long k_ts,
                            long long k_hs, long long v_bs, long long v_ts, long long v_hs,
                            void* out, void* lse, int batch, int heads, int n, int m, int d,
                            int is_f32, float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d % 8 != 0 || d < 8) return static_cast<int>(cudaErrorInvalidValue);
  if (d > 128) {
#define FT_WIDE(T)                                                                          \
  return launch_wide<T>(q, k, v, q_bs, q_ts, q_hs, k_bs, k_ts, k_hs, v_bs, v_ts, v_hs, out, lse, \
                        batch, heads, n, m, d, scale, s)
    if (is_f32) FT_WIDE(float);
    FT_WIDE(__nv_bfloat16);
#undef FT_WIDE
  }
#define FT_FLASH(T, D)                                                                       \
  return launch<T, D>(q, k, v, q_bs, q_ts, q_hs, k_bs, k_ts, k_hs, v_bs, v_ts, v_hs, out, lse, \
                      batch, heads, n, m, d, scale, s)
  if (is_f32) {
    if (d <= 32) FT_FLASH(float, 32);
    if (d <= 64) FT_FLASH(float, 64);
    FT_FLASH(float, 128);
  }
#undef FT_FLASH
#define FT_MMA(D)                                                                             \
  return launch_mma<D>(q, k, v, q_bs, q_ts, q_hs, k_bs, k_ts, k_hs, v_bs, v_ts, v_hs, out, lse, \
                       batch, heads, n, m, d, scale, s)
  if (d <= 32) FT_MMA(32);
  if (d <= 64) FT_MMA(64);
  FT_MMA(128);
#undef FT_MMA
}

}  // extern "C"
