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
// Numerics follow the TPU kernel: q, k and v are upcast to f32, the scores,
// the probabilities p and the p.v product stay in f32 (the products of bf16
// inputs are exact in f32, so only the order of the sums differs; f32 inputs
// are used as they are), and the
// running max, sum and accumulator are f32. Key columns past M are masked to
// -inf and their rows are never read; query rows past N are never written.
// Every key tile the loop visits holds at least one real key, so the running
// max is finite after the first tile and exp(m_prev - m_new) never sees
// -inf - (-inf).
//
// Bound on the H100: at the fa16 stage (b8 x 4096 queries x 4100 keys x 4
// heads x 32) the two products are 4.BH.N.M.d = 6.9e10 operations, 0.07 ms at
// the bf16 tensor-core rate, against about 34 MB of q, k, v, out and lse
// (0.01 ms at 3.35 TB/s): the kernel is bound by operations.
//
// What the design does about it. This first version is the simple, exact
// one: each thread owns one query row (q and its f32 accumulator in
// registers; at d > 64 four threads share a row), each block walks all key
// tiles of its (batch, head), staging KT keys and values at a time in shared
// memory as f32, so every staged element serves the block's rows. Scores for a whole tile are held in
// registers, so the online-softmax rescale runs once per tile, not per key.
// The products run on the FP32 cores: tensor cores (which would round p to
// bf16 or tf32 for the p.v product) and TMA loads are later work.
//
// A head wider than 128 takes flash_wide (further down): the scores
// accumulate over d in chunks staged in shared memory, and each block owns a
// 128-wide tile of the output columns and recomputes the scores for it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// Head widths come in three buckets with the actual d (a multiple of 8)
// masked at run time: q, k and v columns at or past d are zero, and out
// columns past d are never written. Up to 64 one thread owns a whole query
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

__device__ __forceinline__ void unpack8(const uint4 raw, float* f) {
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(h2[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* f) {
  unpack8(*reinterpret_cast<const uint4*>(p), f);
}
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
  if (d <= 32) FT_FLASH(__nv_bfloat16, 32);
  if (d <= 64) FT_FLASH(__nv_bfloat16, 64);
  FT_FLASH(__nv_bfloat16, 128);
#undef FT_FLASH
}

}  // extern "C"
