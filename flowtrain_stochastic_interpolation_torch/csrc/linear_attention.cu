// Linear attention, forward, written by hand for Hopper (sm_90a), with a plain
// C interface bound from Python through ctypes
// (flowtrain_stochastic_interpolation_torch/ops/linear_attention.py): the
// folded context (K1) and projection (K2) kernels specialised for the
// flagship's 4 x 32 bf16 heads, first; then the general path per (batch,
// head), which serves K1 and K2 at every other head count, width and dtype
// and the v1 kernels K4a and K4b (see its own note further down).
//
// The specialisation works on the head-folded layout [B, N, h*d] with h = 4
// heads of d = 32, so h*d = 128: the layout of the UNet's to_qkv projection,
// read in place through a token stride (q, k and v are column slices of one
// [B, N, 384] tensor; nothing is copied to make them contiguous).
//
// K1 replaces flowtrain_stochastic_interpolation_tpu/ops/linear_attention.py
// _folded_context_kernel (called from _folded_fwd):
//     ctx = blockdiag( softmax over tokens of [mem_k; k] )^T . [mem_v; v]
// per column online max and sum, p and v rounded to bf16 in the product with
// f32 accumulation, the memory tokens in f32, rows divided by the column sums
// and the off-head blocks of the [128, 128] f32 output zeroed.
//
// K2 replaces _folded_project_kernel:
//     out = groupsoftmax(q) * d^-1/2 @ ctx
// with a per-head-group max (never a row max: a row max underflows a head
// whose logits sit far below another's), p and ctx rounded to bf16, f32
// accumulation, bf16 output.
//
// Bound on the H100 (3.35 TB/s, 989 TFLOP/s bf16): at the flagship's largest
// call, 64^3 tokens x batch 8, K1 reads k and v (2 x 537 MB) and K2 reads q
// and writes out (2 x 537 MB). Each moves about 1.07 GB, 0.32 ms at the
// memory rate, against 17 GFLOP of products (0.02 ms at the bf16 rate): both
// are memory-bound.
//
// What the design does about it. Each kernel reads its large inputs exactly
// once with 16-byte (K1) or 8-byte (K2) loads along the 128-wide rows, and
// keeps every intermediate (exp(k), the group softmax of q) in shared memory.
// The TPU kernel carries the online softmax across a sequential grid; on the
// card the blocks run in parallel, so K1 is two launches: a partial pass over
// (token chunk, batch) that keeps a running per-column max m, sum s and the
// four per-head diagonal [32, 32] blocks (the off-diagonal blocks are zeroed
// anyway, which saves 4x the products), and a combine pass that seeds with the
// memory tokens and merges the chunks with the exp(m_c - M) rescale. The
// partials are 17 KB per chunk of 1024 tokens, written once and read once:
// 7% on top of the chunk's 512 KB of k and v.
// K2 keeps the four diagonal blocks of ctx in shared memory for the whole
// block and walks many row tiles, so ctx is read once per block.
// The products run on the FP32 cores in this first version; tensor cores and
// TMA loads are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int HD = 128;      // folded width h*d
constexpr int DH = 32;       // head width d
constexpr int NH = HD / DH;  // heads
constexpr int THREADS = 256;
constexpr int K1_TILE = 32;  // tokens staged in shared memory per step of K1
constexpr int K2_ROWS = 32;  // rows of q per tile of K2
constexpr int COMBINE_ROWS = 8;  // rows of one head's block per combine block

__device__ __forceinline__ float neg_inf() { return -__int_as_float(0x7f800000); }

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ void unpack8(const uint4 raw, float* f) {
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(h2[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

// ---------------------------------------------------------------------------
// K1, pass 1: per (chunk, batch) running column max, sum and diagonal blocks.
// Thread t owns rows d0..d0+3 and columns e0..e0+3 of head t/64's block, and,
// for the column reductions, column t%128 over half t/128 of each tile.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(THREADS)
folded_context_partial(const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       long long k_ld, long long v_ld, long long k_bs, long long v_bs,
                       int n, int chunk, int n_chunks,
                       float* __restrict__ part_m, float* __restrict__ part_s,
                       float* __restrict__ part_ctx) {
  const int c = blockIdx.x, b = blockIdx.y, t = threadIdx.x;
  const int n0 = c * chunk;
  const int n1 = min(n, n0 + chunk);
  const __nv_bfloat16* kb = k + (long long)b * k_bs;
  const __nv_bfloat16* vb = v + (long long)b * v_bs;

  __shared__ __align__(16) float p_s[K1_TILE][HD];  // k, then bf16(exp(k - m))
  __shared__ __align__(16) float v_s[K1_TILE][HD];
  __shared__ float red[2][HD];
  __shared__ float m_run[HD], s_run[HD], alpha_s[HD];

  if (t < HD) {
    m_run[t] = neg_inf();
    s_run[t] = 0.f;
  }

  const int h = t >> 6, local = t & 63;
  const int d0 = (local >> 3) * 4, e0 = (local & 7) * 4;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const int col = t & (HD - 1), half = t >> 7;
  constexpr int HALF_ROWS = K1_TILE / 2;

  for (int base = n0; base < n1; base += K1_TILE) {
    const int rows = min(K1_TILE, n1 - base);
    __syncthreads();  // the previous tile is consumed
    // Rows past the chunk's end are never read: they are filled with
    // k = -inf (so exp gives 0) and v = 0.
    for (int i = t; i < K1_TILE * HD / 8; i += THREADS) {
      const int r = i / (HD / 8), c8 = (i % (HD / 8)) * 8;
      float kf[8], vf[8];
      if (r < rows) {
        const uint4 kraw = *reinterpret_cast<const uint4*>(kb + (long long)(base + r) * k_ld + c8);
        const uint4 vraw = *reinterpret_cast<const uint4*>(vb + (long long)(base + r) * v_ld + c8);
        unpack8(kraw, kf);
        unpack8(vraw, vf);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          kf[j] = neg_inf();
          vf[j] = 0.f;
        }
      }
      float4* pd = reinterpret_cast<float4*>(&p_s[r][c8]);
      float4* vd = reinterpret_cast<float4*>(&v_s[r][c8]);
      pd[0] = make_float4(kf[0], kf[1], kf[2], kf[3]);
      pd[1] = make_float4(kf[4], kf[5], kf[6], kf[7]);
      vd[0] = make_float4(vf[0], vf[1], vf[2], vf[3]);
      vd[1] = make_float4(vf[4], vf[5], vf[6], vf[7]);
    }
    __syncthreads();

    float mx = neg_inf();
#pragma unroll
    for (int r = 0; r < HALF_ROWS; ++r) mx = fmaxf(mx, p_s[half * HALF_ROWS + r][col]);
    red[half][col] = mx;
    __syncthreads();
    if (t < HD) {
      const float m_new = fmaxf(m_run[t], fmaxf(red[0][t], red[1][t]));
      alpha_s[t] = expf(m_run[t] - m_new);  // 0 on the first tile
      m_run[t] = m_new;
    }
    __syncthreads();

    {
      const float m_new = m_run[col];
      float s = 0.f;
#pragma unroll
      for (int r = 0; r < HALF_ROWS; ++r) {
        const int rr = half * HALF_ROWS + r;
        const float p = expf(p_s[rr][col] - m_new);
        s += p;                         // the sum takes exp in f32
        p_s[rr][col] = bf16_round(p);   // the product takes it in bf16
      }
      red[half][col] = s;
    }
    __syncthreads();
    if (t < HD) s_run[t] = s_run[t] * alpha_s[t] + red[0][t] + red[1][t];

    float a[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = alpha_s[h * DH + d0 + i];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] *= a[i];

    for (int r = 0; r < rows; ++r) {
      const float4 pv = *reinterpret_cast<const float4*>(&p_s[r][h * DH + d0]);
      const float4 vv = *reinterpret_cast<const float4*>(&v_s[r][h * DH + e0]);
      // v was bf16 in memory, so it is already a bf16 value
      const float pa[4] = {pv.x, pv.y, pv.z, pv.w};
      const float va[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(pa[i], va[j], acc[i][j]);
    }
  }
  __syncthreads();

  const long long slot = (long long)b * n_chunks + c;
  if (t < HD) {
    part_m[slot * HD + t] = m_run[t];
    part_s[slot * HD + t] = s_run[t];
  }
  float* pc = part_ctx + (slot * NH + h) * DH * DH;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    *reinterpret_cast<float4*>(&pc[(d0 + i) * DH + e0]) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
}

// ---------------------------------------------------------------------------
// K1, pass 2: per (head, 8-row slab, batch) merge of the chunks, seeded with
// the memory tokens, divided by the column sums; writes the full [128, 128]
// rows with zeros off the head's diagonal block.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(THREADS)
folded_context_combine(const float* __restrict__ part_m, const float* __restrict__ part_s,
                       const float* __restrict__ part_ctx,
                       const __nv_bfloat16* __restrict__ mem_k,
                       const __nv_bfloat16* __restrict__ mem_v, int n_mem,
                       int n_chunks, float* __restrict__ ctx) {
  const int slabs = DH / COMBINE_ROWS;
  const int h = blockIdx.x / slabs, slab = blockIdx.x % slabs, b = blockIdx.y;
  const int t = threadIdx.x;
  const int d = slab * COMBINE_ROWS + (t >> 5), e = t & 31;
  const int kc = h * DH + d, vc = h * DH + e;

  // memory tokens in f32, as the TPU kernel's seeding step
  float m0 = neg_inf();
  for (int j = 0; j < n_mem; ++j) m0 = fmaxf(m0, __bfloat162float(mem_k[j * HD + kc]));
  float s0 = 0.f, c0 = 0.f;
  for (int j = 0; j < n_mem; ++j) {
    const float p = expf(__bfloat162float(mem_k[j * HD + kc]) - m0);
    s0 += p;
    c0 = fmaf(p, __bfloat162float(mem_v[j * HD + vc]), c0);
  }

  const long long first = (long long)b * n_chunks;
  float big_m = m0;
  for (int c = 0; c < n_chunks; ++c) big_m = fmaxf(big_m, part_m[(first + c) * HD + kc]);
  float w = expf(m0 - big_m);
  float s = s0 * w, acc = c0 * w;
  for (int c = 0; c < n_chunks; ++c) {
    const long long slot = first + c;
    w = expf(part_m[slot * HD + kc] - big_m);
    s = fmaf(part_s[slot * HD + kc], w, s);
    acc = fmaf(part_ctx[((slot * NH + h) * DH + d) * DH + e], w, acc);
  }

  float* row = ctx + ((long long)b * HD + kc) * HD;
#pragma unroll
  for (int hh = 0; hh < NH; ++hh) row[hh * DH + e] = (hh == h) ? acc / s : 0.f;
}

// ---------------------------------------------------------------------------
// K2: out = groupsoftmax(q) * scale @ ctx, per (row tile, batch). The block
// stages ctx's diagonal blocks once (rounded to bf16), then walks row tiles.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(THREADS)
folded_project(const __nv_bfloat16* __restrict__ q, long long q_ld, long long q_bs,
               const float* __restrict__ ctx, __nv_bfloat16* __restrict__ out,
               int n, int n_tiles, float scale) {
  const int b = blockIdx.y, t = threadIdx.x;
  const int warp = t >> 5, lane = t & 31;

  __shared__ __align__(16) float ctx_s[NH][DH][DH];
  // p padded by one float per head so the four heads' reads fall in four banks
  __shared__ float p_s[K2_ROWS][NH * (DH + 1)];

  const float* cb = ctx + (long long)b * HD * HD;
  for (int i = t; i < NH * DH * DH; i += THREADS) {
    const int hh = i / (DH * DH), d = (i / DH) % DH, e = i % DH;
    ctx_s[hh][d][e] = bf16_round(cb[(hh * DH + d) * HD + hh * DH + e]);
  }

  const __nv_bfloat16* qb = q + (long long)b * q_bs;
  __nv_bfloat16* ob = out + (long long)b * n * HD;
  const int cg = t & 31, rg = t >> 5;   // output: columns cg*4.., rows rg*4..
  const int oh = cg >> 3, oe = (cg & 7) * 4;
  constexpr int ROWS_PER_WARP = K2_ROWS / (THREADS / 32);

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int row0 = tile * K2_ROWS;
    __syncthreads();  // ctx_s is staged, or the previous tile is consumed
    // group softmax: one warp per row, lane l holds columns 4l..4l+3, so the
    // eight lanes of a head group reduce among themselves
#pragma unroll
    for (int i = 0; i < ROWS_PER_WARP; ++i) {
      const int r = warp * ROWS_PER_WARP + i;
      if (row0 + r >= n) break;
      const uint2 raw = *reinterpret_cast<const uint2*>(qb + (long long)(row0 + r) * q_ld + lane * 4);
      const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
      const float2 x01 = __bfloat1622float2(h2[0]);
      const float2 x23 = __bfloat1622float2(h2[1]);
      float x[4] = {x01.x, x01.y, x23.x, x23.y};
      float mx = fmaxf(fmaxf(x[0], x[1]), fmaxf(x[2], x[3]));
#pragma unroll
      for (int off = 1; off < 8; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        x[j] = expf(x[j] - mx);
        sum += x[j];
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const int hh = lane >> 3, dd = (lane & 7) * 4;
#pragma unroll
      for (int j = 0; j < 4; ++j) p_s[r][hh * (DH + 1) + dd + j] = bf16_round((x[j] / sum) * scale);
    }
    __syncthreads();

    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      const float4 cv = *reinterpret_cast<const float4*>(&ctx_s[oh][d][oe]);
      const float ca[4] = {cv.x, cv.y, cv.z, cv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = p_s[rg * 4 + i][oh * (DH + 1) + d];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(p, ca[j], acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = row0 + rg * 4 + i;
      if (row >= n) break;
      const __nv_bfloat162 lo = __floats2bfloat162_rn(acc[i][0], acc[i][1]);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(acc[i][2], acc[i][3]);
      uint2 packed;
      packed.x = *reinterpret_cast<const uint32_t*>(&lo);
      packed.y = *reinterpret_cast<const uint32_t*>(&hi);
      *reinterpret_cast<uint2*>(ob + (long long)row * HD + cg * 4) = packed;
    }
  }
}

// ===========================================================================
// The general path: one (batch, head) pair per block row of the grid, any
// number of heads, any head width d with d % 8 == 0, bf16 or f32 operands,
// each read in place through its batch, token and head strides.
//
// It serves two pairs of TPU kernels:
//   * K1 and K2 beyond the 4 x 32 bf16 specialisation above (folded layout
//     [B, N, h*d], head stride d; K1 keeps only the per-head diagonal blocks,
//     which is exactly a per-(batch, head) context; round_bf16 = 1);
//   * K4a and K4b, the v1 linear attention, which replace
//     flowtrain_stochastic_interpolation_tpu/ops/linear_attention.py
//     _context_kernel (called from _linear_attn_fwd_bhnd):
//         ctx = softmax over tokens of k, per column, ^T . v
//     with no memory-token seed (the caller concatenated the memory tokens
//     into k and v, so they are the first rows), everything in f32; and
//     _project_kernel:
//         out = softmax_d(q) * d^-1/2 @ ctx
//     in f32, output in q's dtype (round_bf16 = 0). q is read from the
//     [B, N, 3, h, d] projection and k, v from the [B, M, h, d]
//     concatenations in place: the TPU's [B*h, N, d] transposes are gone.
//
// The head width is a template bucket (32, 64 or 128) with the actual d
// masked at run time: columns at or past d are loaded as k = -inf, v = 0 and
// q = -inf, and are never written. A head wider than 128 works in column
// tiles of 128: the context's d x d block is cut into 128 x 128 tiles, one
// per blockIdx.z, each reusing the 128 bucket with a k-column and a v-column
// offset (the softmax statistics are per k column, so the tiles are
// independent; a tile recomputes exp(k - m) for its k columns once per
// v-column tile); the projection runs project_wide, below.
//
// Bound on the H100: at b8 x 64^3 with 4 heads x 32, bf16, the context reads
// k and v (2 x 537 MB) and the projection reads q and writes out (2 x 537
// MB): about 0.32 ms each at 3.35 TB/s, against 17 GFLOP of f32 products
// (0.26 ms at the 67 TFLOP/s of the FP32 cores): both are memory-bound, with
// the products close behind.
//
// What the design does about it: the context is a partial pass over
// (token chunk, batch*head), reading each k and v row once, keeping exp(k - m)
// in shared memory and the d x d partial block in registers, then a combine
// pass that merges the chunks with the exp(m_c - M) rescale (the TPU's
// sequential key axis cannot run in order on the card). For d <= 32 four
// copies of the block accumulate interleaved tokens, so each thread does 16
// products per two shared loads, and are summed at the end. The projection
// keeps the d x d block in shared memory for the whole block and walks many
// row tiles, so ctx is read once per block. The products run on the FP32
// cores; tensor cores and TMA loads are later work.
// ===========================================================================

__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(float x) { return x; }

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

constexpr int CTX_TILE = 32;  // tokens staged in shared memory per step of the context

// The d x d block of one (batch, head) is split over threads in TI x TI
// tiles; LANES threads hold one copy of it and GROUPS copies accumulate
// interleaved tokens.
template <int DB>
struct CtxShape {
  static constexpr int TI = DB <= 64 ? 4 : 8;
  static constexpr int LANES = (DB / TI) * (DB / TI);  // 64, 256, 256
  static constexpr int GROUPS = THREADS / LANES;       // 4, 1, 1
  static constexpr int PARTS = THREADS / DB;           // threads per column in the reductions
  static constexpr int PART_ROWS = CTX_TILE / PARTS;
};

// Context, pass 1: per (chunk, batch*head) the running column max, sum and
// the d x d block, rescaled to the running max.
template <typename T, int DB>
__global__ void __launch_bounds__(THREADS)
context_partial(const T* __restrict__ k, const T* __restrict__ v,
                long long k_bs, long long k_ts, long long k_hs,
                long long v_bs, long long v_ts, long long v_hs,
                int heads, int d, int n, int chunk, int n_chunks, int round_bf16, int tiles,
                float* __restrict__ part_m, float* __restrict__ part_s,
                float* __restrict__ part_ctx) {
  using S = CtxShape<DB>;
  const int c = blockIdx.x, bh = blockIdx.y, t = threadIdx.x;
  const int b = bh / heads, h = bh % heads;
  const int n0 = c * chunk;
  const int n1 = min(n, n0 + chunk);
  // this block's tile of the d x d block: k columns k_off.., v columns v_off..
  // (the whole block, tiles == 1, for d <= DB)
  const int kt = blockIdx.z / tiles, vt = blockIdx.z % tiles;
  const int k_off = kt * DB, v_off = vt * DB;
  const int dk = min(DB, d - k_off), dv = min(DB, d - v_off);
  const T* kb = k + b * k_bs + h * k_hs + k_off;
  const T* vb = v + b * v_bs + h * v_hs + v_off;

  __shared__ __align__(16) float p_s[CTX_TILE][DB];  // k, then exp(k - m)
  __shared__ __align__(16) float v_s[CTX_TILE][DB];
  __shared__ float red[S::PARTS][DB];
  __shared__ float m_run[DB], s_run[DB], alpha_s[DB];
  __shared__ __align__(16) float acc_s[S::GROUPS > 1 ? (S::GROUPS - 1) * DB * DB : 4];

  if (t < DB) {
    m_run[t] = neg_inf();
    s_run[t] = 0.f;
  }
  const int g = t / S::LANES, lane = t % S::LANES;
  const int d0 = (lane / (DB / S::TI)) * S::TI, e0 = (lane % (DB / S::TI)) * S::TI;
  // d % 8 == 0, so a thread's rows (and columns) are all inside the tile or all past it
  const bool owns = d0 < dk && e0 < dv;
  float acc[S::TI][S::TI];
#pragma unroll
  for (int i = 0; i < S::TI; ++i)
#pragma unroll
    for (int j = 0; j < S::TI; ++j) acc[i][j] = 0.f;
  const int col = t % DB, part = t / DB;

  for (int base = n0; base < n1; base += CTX_TILE) {
    const int rows = min(CTX_TILE, n1 - base);
    __syncthreads();  // the previous tile is consumed
    // rows past the chunk's end and columns past the tile are never read:
    // k = -inf (so exp gives 0) and v = 0
    for (int i = t; i < CTX_TILE * DB / 8; i += THREADS) {
      const int r = i / (DB / 8), c8 = (i % (DB / 8)) * 8;
      float kf[8], vf[8];
      const bool k_in = r < rows && c8 < dk, v_in = r < rows && c8 < dv;
      if (k_in && v_in) {  // both loads in one block, issued together
        load8(kb + (long long)(base + r) * k_ts + c8, kf);
        load8(vb + (long long)(base + r) * v_ts + c8, vf);
      } else {  // masked rows, and a column inside one side's tile only (d > 128)
        if (k_in) {
          load8(kb + (long long)(base + r) * k_ts + c8, kf);
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j) kf[j] = neg_inf();
        }
        if (v_in) {
          load8(vb + (long long)(base + r) * v_ts + c8, vf);
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j) vf[j] = 0.f;
        }
      }
      if (round_bf16) {
#pragma unroll
        for (int j = 0; j < 8; ++j) vf[j] = bf16_round(vf[j]);
      }
      float4* pd = reinterpret_cast<float4*>(&p_s[r][c8]);
      float4* vd = reinterpret_cast<float4*>(&v_s[r][c8]);
      pd[0] = make_float4(kf[0], kf[1], kf[2], kf[3]);
      pd[1] = make_float4(kf[4], kf[5], kf[6], kf[7]);
      vd[0] = make_float4(vf[0], vf[1], vf[2], vf[3]);
      vd[1] = make_float4(vf[4], vf[5], vf[6], vf[7]);
    }
    __syncthreads();

    float mx = neg_inf();
#pragma unroll
    for (int r = 0; r < S::PART_ROWS; ++r) mx = fmaxf(mx, p_s[part * S::PART_ROWS + r][col]);
    red[part][col] = mx;
    __syncthreads();
    if (t < dk) {
      float m_new = m_run[t];
#pragma unroll
      for (int q = 0; q < S::PARTS; ++q) m_new = fmaxf(m_new, red[q][t]);
      alpha_s[t] = expf(m_run[t] - m_new);  // 0 on the first tile: each tile has a real row
      m_run[t] = m_new;
    }
    __syncthreads();

    float s = 0.f;
    if (col < dk) {
      const float m_new = m_run[col];
#pragma unroll
      for (int r = 0; r < S::PART_ROWS; ++r) {
        const int rr = part * S::PART_ROWS + r;
        const float p = expf(p_s[rr][col] - m_new);
        s += p;  // the sum takes exp in f32
        p_s[rr][col] = round_bf16 ? bf16_round(p) : p;
      }
    }
    red[part][col] = s;
    __syncthreads();
    if (t < dk) {
      float sum = 0.f;
#pragma unroll
      for (int q = 0; q < S::PARTS; ++q) sum += red[q][t];
      s_run[t] = s_run[t] * alpha_s[t] + sum;
    }

    if (owns) {
#pragma unroll
      for (int i = 0; i < S::TI; ++i) {
        const float a = alpha_s[d0 + i];
#pragma unroll
        for (int j = 0; j < S::TI; ++j) acc[i][j] *= a;
      }
      for (int r = g; r < rows; r += S::GROUPS) {
        float pa[S::TI], va[S::TI];
#pragma unroll
        for (int i = 0; i < S::TI; i += 4) {
          const float4 pv = *reinterpret_cast<const float4*>(&p_s[r][d0 + i]);
          const float4 vv = *reinterpret_cast<const float4*>(&v_s[r][e0 + i]);
          pa[i] = pv.x; pa[i + 1] = pv.y; pa[i + 2] = pv.z; pa[i + 3] = pv.w;
          va[i] = vv.x; va[i + 1] = vv.y; va[i + 2] = vv.z; va[i + 3] = vv.w;
        }
#pragma unroll
        for (int i = 0; i < S::TI; ++i)
#pragma unroll
          for (int j = 0; j < S::TI; ++j) acc[i][j] = fmaf(pa[i], va[j], acc[i][j]);
      }
    }
  }

  if (S::GROUPS > 1) {  // sum the copies of the block into group 0's
    __syncthreads();
    if (g > 0 && owns) {
      float* dst = acc_s + (g - 1) * DB * DB;
#pragma unroll
      for (int i = 0; i < S::TI; ++i)
#pragma unroll
        for (int j = 0; j < S::TI; ++j) dst[(d0 + i) * DB + e0 + j] = acc[i][j];
    }
    __syncthreads();
    if (g == 0 && owns) {
      for (int gg = 0; gg < S::GROUPS - 1; ++gg) {
        const float* src = acc_s + gg * DB * DB;
#pragma unroll
        for (int i = 0; i < S::TI; ++i)
#pragma unroll
          for (int j = 0; j < S::TI; ++j) acc[i][j] += src[(d0 + i) * DB + e0 + j];
      }
    }
  }

  const long long slot = (long long)bh * n_chunks + c;
  if (vt == 0 && t < dk) {  // the statistics of the k columns, once
    part_m[slot * d + k_off + t] = m_run[t];
    part_s[slot * d + k_off + t] = s_run[t];
  }
  if (g == 0 && owns) {
    float* pc = part_ctx + slot * d * d + (long long)k_off * d + v_off;
#pragma unroll
    for (int i = 0; i < S::TI; ++i)
#pragma unroll
      for (int j = 0; j < S::TI; ++j) pc[(d0 + i) * d + e0 + j] = acc[i][j];
  }
}

// Context, pass 2: one thread per output entry (i, col) of the rows of one
// (batch, head) block. The chunks are merged with the exp(m_c - M) rescale,
// seeded with the n_mem memory tokens in f32 (K1; none for K4a), and divided
// by the column sums. width = d writes ctx [B*h, d, d] (K4a); width = h*d
// writes the folded [B, h*d, h*d] rows, zero off the head's diagonal block (K1).
template <typename T>
__global__ void __launch_bounds__(THREADS)
context_combine(const float* __restrict__ part_m, const float* __restrict__ part_s,
                const float* __restrict__ part_ctx, const T* __restrict__ mem_k,
                const T* __restrict__ mem_v, int n_mem, int heads, int d, int n_chunks,
                int width, float* __restrict__ ctx) {
  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const long long idx = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (idx >= (long long)d * width) return;
  const int i = idx / width, col = idx % width;
  const bool folded = width != d;
  float* row = folded ? ctx + ((long long)b * width + h * d + i) * width
                      : ctx + ((long long)bh * d + i) * d;
  const int j = folded ? col - h * d : col;
  if (j < 0 || j >= d) {
    row[col] = 0.f;
    return;
  }
  // memory tokens [n_mem, h*d], in f32, as the TPU kernel's seeding step
  const int hd = heads * d;
  float m0 = neg_inf();
  for (int r = 0; r < n_mem; ++r) m0 = fmaxf(m0, to_f32(mem_k[r * hd + h * d + i]));
  float s0 = 0.f, c0 = 0.f;
  for (int r = 0; r < n_mem; ++r) {
    const float p = expf(to_f32(mem_k[r * hd + h * d + i]) - m0);
    s0 += p;
    c0 = fmaf(p, to_f32(mem_v[r * hd + h * d + j]), c0);
  }

  const long long first = (long long)bh * n_chunks;
  float big_m = m0;
  for (int c = 0; c < n_chunks; ++c) big_m = fmaxf(big_m, part_m[(first + c) * d + i]);
  float w = expf(m0 - big_m);  // 0 without memory tokens
  float s = s0 * w, acc = c0 * w;
  for (int c = 0; c < n_chunks; ++c) {
    const long long slot = first + c;
    w = expf(part_m[slot * d + i] - big_m);
    s = fmaf(part_s[slot * d + i], w, s);
    acc = fmaf(part_ctx[(slot * d + i) * d + j], w, acc);
  }
  row[col] = acc / s;
}

// Projection: out = softmax_d(q) * scale @ ctx per (row tile, batch*head).
// The block stages the d x d block of ctx once (rounded to bf16 for K2), then
// walks row tiles: a group of DB/4 lanes takes the softmax of one q row
// (4 columns each), then each thread computes 4 rows x 4 columns of out.
template <int DB>
struct ProjShape {
  static constexpr int ROWS = 4096 / DB;     // rows of q per tile: 128, 64, 32
  static constexpr int COLS = DB / 4;        // threads across a row of out
  static constexpr int QL = DB / 4;          // lanes per q row in the softmax
  static constexpr int PASS = 32 / QL;       // q rows per warp pass
  static constexpr int SMEM = (DB * DB + ROWS * (DB + 1)) * 4;  // bytes: 21, 33, 82 KB
};

template <typename T, int DB>
__global__ void __launch_bounds__(THREADS)
project_general(const T* __restrict__ q, long long q_bs, long long q_ts, long long q_hs,
                const float* __restrict__ ctx, long long c_bs, long long c_hs, long long c_ld,
                T* __restrict__ out, int heads, int d, int n, int n_tiles, int round_bf16,
                float scale) {
  using S = ProjShape<DB>;
  const int bh = blockIdx.y, b = bh / heads, h = bh % heads, t = threadIdx.x;
  const int warp = t >> 5, lane = t & 31;

  // dynamic: at DB = 128 the block of ctx alone is 64 KB
  extern __shared__ __align__(16) float smem[];
  float (*ctx_s)[DB] = reinterpret_cast<float (*)[DB]>(smem);
  // padded: the 4 rows a warp reads fall in 4 banks
  float (*p_s)[DB + 1] = reinterpret_cast<float (*)[DB + 1]>(smem + DB * DB);

  const float* cb = ctx + b * c_bs + h * c_hs;
  for (int i = t; i < DB * DB; i += THREADS) {
    const int r = i / DB, e = i % DB;
    const float x = (r < d && e < d) ? cb[r * c_ld + e] : 0.f;
    ctx_s[r][e] = round_bf16 ? bf16_round(x) : x;
  }

  const T* qb = q + b * q_bs + h * q_hs;
  const long long o_ts = (long long)heads * d;
  T* ob = out + (long long)b * n * o_ts + h * d;
  const int sub = lane / S::QL, c0 = (lane % S::QL) * 4;
  const int cg = t % S::COLS, rg = t / S::COLS;  // out: columns cg*4.., rows rg*4..

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int row0 = tile * S::ROWS;
    __syncthreads();  // ctx_s is staged, or the previous tile is consumed
    // ROWS / (8 warps * PASS) = 4 passes for every bucket, the same for all lanes
    for (int r = warp * S::PASS + sub; r < S::ROWS; r += 8 * S::PASS) {
      float x[4];
      if (row0 + r >= n) {
#pragma unroll
        for (int j = 0; j < 4; ++j) x[j] = 0.f;  // a row past n: finite, never written
      } else if (c0 < d) {
        load4(qb + (long long)(row0 + r) * q_ts + c0, x);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) x[j] = neg_inf();
      }
      float mx = fmaxf(fmaxf(x[0], x[1]), fmaxf(x[2], x[3]));
#pragma unroll
      for (int off = 1; off < S::QL; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        x[j] = expf(x[j] - mx);
        sum += x[j];
      }
#pragma unroll
      for (int off = 1; off < S::QL; off <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = (x[j] / sum) * scale;
        p_s[r][c0 + j] = round_bf16 ? bf16_round(p) : p;
      }
    }
    __syncthreads();

    if (cg * 4 < d) {
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 8
      for (int dd = 0; dd < d; ++dd) {
        const float4 cv = *reinterpret_cast<const float4*>(&ctx_s[dd][cg * 4]);
        const float ca[4] = {cv.x, cv.y, cv.z, cv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = p_s[rg * 4 + i][dd];
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(p, ca[j], acc[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = row0 + rg * 4 + i;
        if (row >= n) break;
        store4(ob + row * o_ts + cg * 4, acc[i]);
      }
    }
  }
}

// Projection at d > 128: out = softmax_d(q) * scale @ ctx per (row tile,
// batch*head, 128-wide column tile of out). The block first takes each row's
// max and sum over the whole head row of q (K2's group max: one head's
// columns), then walks the d rows of ctx in chunks of WIDE_KC, staging the
// chunk's [WIDE_KC, 128] slice of ctx (rounded to bf16 for K2) and the
// matching columns of p in shared memory, 40 KB in all; each thread
// accumulates 4 rows x 4 columns. ctx is staged anew for every row tile (it
// stays in L2), and q is read once per column tile plus once for the
// statistics: simple, and right at every d.
constexpr int WIDE_ROWS = 32;   // rows of q per tile
constexpr int WIDE_COLS = 128;  // output columns per block
constexpr int WIDE_KC = 64;     // rows of ctx per staged chunk

template <typename T>
__global__ void __launch_bounds__(THREADS)
project_wide(const T* __restrict__ q, long long q_bs, long long q_ts, long long q_hs,
             const float* __restrict__ ctx, long long c_bs, long long c_hs, long long c_ld,
             T* __restrict__ out, int heads, int d, int n, int n_tiles, int round_bf16,
             float scale) {
  const int bh = blockIdx.y, b = bh / heads, h = bh % heads, t = threadIdx.x;
  const int warp = t >> 5, lane = t & 31;
  const int col0 = blockIdx.z * WIDE_COLS;

  __shared__ __align__(16) float ctx_s[WIDE_KC][WIDE_COLS];
  __shared__ float p_s[WIDE_ROWS][WIDE_KC + 1];
  __shared__ float m_s[WIDE_ROWS], s_s[WIDE_ROWS];

  const T* qb = q + b * q_bs + h * q_hs;
  const float* cb = ctx + b * c_bs + h * c_hs;
  const long long o_ts = (long long)heads * d;
  T* ob = out + (long long)b * n * o_ts + h * d;
  const int cg = t % (WIDE_COLS / 4), rg = t / (WIDE_COLS / 4);  // columns cg*4.., rows rg*4..
  constexpr int ROWS_PER_WARP = WIDE_ROWS / (THREADS / 32);

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int row0 = tile * WIDE_ROWS;
    __syncthreads();  // the previous tile is consumed
    // the softmax statistics of each row over all d columns: one warp per row
#pragma unroll
    for (int i = 0; i < ROWS_PER_WARP; ++i) {
      const int r = warp * ROWS_PER_WARP + i, row = row0 + r;
      float mx = 0.f, sum = 1.f;  // a row past n: finite, never written
      if (row < n) {
        const T* qr = qb + (long long)row * q_ts;
        mx = neg_inf();
        for (int c = lane; c < d; c += 32) mx = fmaxf(mx, to_f32(qr[c]));
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        sum = 0.f;
        for (int c = lane; c < d; c += 32) sum += expf(to_f32(qr[c]) - mx);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      }
      if (lane == 0) {
        m_s[r] = mx;
        s_s[r] = sum;
      }
    }

    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int dd0 = 0; dd0 < d; dd0 += WIDE_KC) {
      __syncthreads();  // the statistics are written, or the previous chunk is consumed
      for (int i = t; i < WIDE_KC * WIDE_COLS; i += THREADS) {
        const int r = i / WIDE_COLS, e = i % WIDE_COLS;
        const float x = (dd0 + r < d && col0 + e < d) ? cb[(long long)(dd0 + r) * c_ld + col0 + e] : 0.f;
        ctx_s[r][e] = round_bf16 ? bf16_round(x) : x;
      }
      for (int i = t; i < WIDE_ROWS * WIDE_KC; i += THREADS) {
        const int r = i / WIDE_KC, c = i % WIDE_KC, row = row0 + r;
        float p = 0.f;
        if (row < n && dd0 + c < d) {
          p = (expf(to_f32(qb[(long long)row * q_ts + dd0 + c]) - m_s[r]) / s_s[r]) * scale;
          if (round_bf16) p = bf16_round(p);
        }
        p_s[r][c] = p;
      }
      __syncthreads();
      const int kc = min(WIDE_KC, d - dd0);
      for (int c = 0; c < kc; ++c) {
        const float4 cv = *reinterpret_cast<const float4*>(&ctx_s[c][cg * 4]);
        const float ca[4] = {cv.x, cv.y, cv.z, cv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = p_s[rg * 4 + i][c];
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(p, ca[j], acc[i][j]);
        }
      }
    }
    if (col0 + cg * 4 < d) {  // d % 8 == 0: the 4 columns are all inside d or all past it
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = row0 + rg * 4 + i;
        if (row >= n) break;
        store4(ob + row * o_ts + col0 + cg * 4, acc[i]);
      }
    }
  }
}

template <typename T, int DB>
int launch_context(const void* k, const void* v, long long k_bs, long long k_ts, long long k_hs,
                   long long v_bs, long long v_ts, long long v_hs, const void* mem_k,
                   const void* mem_v, int n_mem, int batch, int heads, int d, int n, int chunk,
                   int round_bf16, int width, float* part_m, float* part_s, float* part_ctx,
                   float* ctx, cudaStream_t s) {
  const int n_chunks = (n + chunk - 1) / chunk;
  const int tiles = (d + DB - 1) / DB;  // 1 unless d > 128
  context_partial<T, DB><<<dim3(n_chunks, batch * heads, tiles * tiles), THREADS, 0, s>>>(
      static_cast<const T*>(k), static_cast<const T*>(v), k_bs, k_ts, k_hs, v_bs, v_ts, v_hs,
      heads, d, n, chunk, n_chunks, round_bf16, tiles, part_m, part_s, part_ctx);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long entries = (long long)d * width;
  context_combine<T><<<dim3((entries + THREADS - 1) / THREADS, batch * heads), THREADS, 0, s>>>(
      part_m, part_s, part_ctx, static_cast<const T*>(mem_k), static_cast<const T*>(mem_v),
      n_mem, heads, d, n_chunks, width, ctx);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DB>
int launch_project(const void* q, long long q_bs, long long q_ts, long long q_hs,
                   const void* ctx, long long c_bs, long long c_hs, long long c_ld, void* out,
                   int batch, int heads, int d, int n, int grid_x, int round_bf16, float scale,
                   cudaStream_t s) {
  using S = ProjShape<DB>;
  static bool sized = false;  // above 48 KB only once the kernel is allowed to
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        project_general<T, DB>, cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    sized = true;
  }
  const int n_tiles = (n + S::ROWS - 1) / S::ROWS;
  project_general<T, DB><<<dim3(grid_x, batch * heads), THREADS, S::SMEM, s>>>(
      static_cast<const T*>(q), q_bs, q_ts, q_hs, static_cast<const float*>(ctx), c_bs, c_hs,
      c_ld, static_cast<T*>(out), heads, d, n, n_tiles, round_bf16, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_project_wide(const void* q, long long q_bs, long long q_ts, long long q_hs,
                        const void* ctx, long long c_bs, long long c_hs, long long c_ld,
                        void* out, int batch, int heads, int d, int n, int grid_x,
                        int round_bf16, float scale, cudaStream_t s) {
  const int n_tiles = (n + WIDE_ROWS - 1) / WIDE_ROWS;
  const int col_tiles = (d + WIDE_COLS - 1) / WIDE_COLS;
  project_wide<T><<<dim3(grid_x, batch * heads, col_tiles), THREADS, 0, s>>>(
      static_cast<const T*>(q), q_bs, q_ts, q_hs, static_cast<const float*>(ctx), c_bs, c_hs,
      c_ld, static_cast<T*>(out), heads, d, n, n_tiles, round_bf16, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// K1: ctx [batch, 128, 128] f32 from k, v [batch, n, 128] bf16 (token stride
// k_ld / v_ld elements, batch stride k_bs / v_bs) and mem_k, mem_v
// [n_mem, 128] bf16. part_m, part_s [batch, n_chunks, 128] and part_ctx
// [batch, n_chunks, 4, 32, 32] f32 are scratch, n_chunks = ceil(n / chunk).
// Returns cudaGetLastError() after the two launches.
int folded_context_forward(const void* k, const void* v, long long k_ld, long long v_ld,
                           long long k_bs, long long v_bs, const void* mem_k,
                           const void* mem_v, int n_mem, int batch, int n, int chunk,
                           void* part_m, void* part_s, void* part_ctx, void* ctx,
                           void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_chunks = (n + chunk - 1) / chunk;
  folded_context_partial<<<dim3(n_chunks, batch), THREADS, 0, s>>>(
      static_cast<const __nv_bfloat16*>(k), static_cast<const __nv_bfloat16*>(v), k_ld, v_ld,
      k_bs, v_bs, n, chunk, n_chunks, static_cast<float*>(part_m),
      static_cast<float*>(part_s), static_cast<float*>(part_ctx));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  folded_context_combine<<<dim3(NH * (DH / COMBINE_ROWS), batch), THREADS, 0, s>>>(
      static_cast<const float*>(part_m), static_cast<const float*>(part_s),
      static_cast<const float*>(part_ctx), static_cast<const __nv_bfloat16*>(mem_k),
      static_cast<const __nv_bfloat16*>(mem_v), n_mem, n_chunks, static_cast<float*>(ctx));
  return static_cast<int>(cudaGetLastError());
}

// K2: out [batch, n, 128] bf16 (contiguous) from q [batch, n, 128] bf16
// (token stride q_ld, batch stride q_bs) and ctx [batch, 128, 128] f32.
// Returns cudaGetLastError() after the launch.
int folded_project_forward(const void* q, long long q_ld, long long q_bs, const void* ctx,
                           void* out, int batch, int n, int grid_x, float scale,
                           void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_tiles = (n + K2_ROWS - 1) / K2_ROWS;
  folded_project<<<dim3(grid_x, batch), THREADS, 0, s>>>(
      static_cast<const __nv_bfloat16*>(q), q_ld, q_bs, static_cast<const float*>(ctx),
      static_cast<__nv_bfloat16*>(out), n, n_tiles, scale);
  return static_cast<int>(cudaGetLastError());
}

// The general context (K1 beyond 4 x 32 bf16, and K4a): ctx from k, v
// [batch, n, heads, d] (bf16 if is_f32 == 0, else f32) given by their batch,
// token and head strides in elements (d contiguous, rows 16-byte aligned).
// width = d: ctx [batch*heads, d, d] f32 (K4a; n_mem = 0, mem_k = mem_v =
// NULL). width = heads*d: ctx [batch, heads*d, heads*d] f32, zero off the
// head-diagonal blocks, seeded with mem_k, mem_v [n_mem, heads*d] (K1).
// round_bf16 rounds exp(k - m) and v to bf16 in the product (K1). part_m,
// part_s [batch*heads, n_chunks, d] and part_ctx [batch*heads, n_chunks, d, d]
// f32 are scratch, n_chunks = ceil(n / chunk). d % 8 == 0 (a d above 128 runs
// the 128 bucket over ceil(d / 128)^2 column tiles), else
// cudaErrorInvalidValue. Returns cudaGetLastError() after the two launches.
int context_forward(const void* k, const void* v, int is_f32, long long k_bs, long long k_ts,
                    long long k_hs, long long v_bs, long long v_ts, long long v_hs,
                    const void* mem_k, const void* mem_v, int n_mem, int batch, int heads,
                    int d, int n, int chunk, int round_bf16, int width, void* part_m,
                    void* part_s, void* part_ctx, void* ctx, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d % 8 != 0 || d < 8) return static_cast<int>(cudaErrorInvalidValue);
  float* pm = static_cast<float*>(part_m);
  float* ps = static_cast<float*>(part_s);
  float* pc = static_cast<float*>(part_ctx);
  float* out = static_cast<float*>(ctx);
#define FT_CONTEXT(T, DB)                                                                   \
  return launch_context<T, DB>(k, v, k_bs, k_ts, k_hs, v_bs, v_ts, v_hs, mem_k, mem_v, n_mem, \
                               batch, heads, d, n, chunk, round_bf16, width, pm, ps, pc, out, s)
  if (is_f32) {
    if (d <= 32) FT_CONTEXT(float, 32);
    if (d <= 64) FT_CONTEXT(float, 64);
    FT_CONTEXT(float, 128);
  }
  if (d <= 32) FT_CONTEXT(__nv_bfloat16, 32);
  if (d <= 64) FT_CONTEXT(__nv_bfloat16, 64);
  FT_CONTEXT(__nv_bfloat16, 128);
#undef FT_CONTEXT
}

// The general projection (K2 beyond 4 x 32 bf16, and K4b): out [batch, n,
// heads, d] (contiguous, in q's dtype) = softmax_d(q) * scale @ ctx, with q
// [batch, n, heads, d] given by its strides and the d x d block of (b, h) at
// ctx + b*c_bs + h*c_hs, rows c_ld apart (f32). round_bf16 rounds p and ctx
// to bf16 (K2). grid_x blocks per (batch, head) walk the row tiles (of 4096 /
// DB rows up to d = 128, of 32 rows in each 128-wide column tile above).
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue for a
// d that is not a multiple of 8.
int project_forward(const void* q, int is_f32, long long q_bs, long long q_ts, long long q_hs,
                    const void* ctx, long long c_bs, long long c_hs, long long c_ld, void* out,
                    int batch, int heads, int d, int n, int grid_x, int round_bf16,
                    float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d % 8 != 0 || d < 8) return static_cast<int>(cudaErrorInvalidValue);
  if (d > 128) {
    if (is_f32)
      return launch_project_wide<float>(q, q_bs, q_ts, q_hs, ctx, c_bs, c_hs, c_ld, out, batch,
                                        heads, d, n, grid_x, round_bf16, scale, s);
    return launch_project_wide<__nv_bfloat16>(q, q_bs, q_ts, q_hs, ctx, c_bs, c_hs, c_ld, out,
                                              batch, heads, d, n, grid_x, round_bf16, scale, s);
  }
#define FT_PROJECT(T, DB)                                                                   \
  return launch_project<T, DB>(q, q_bs, q_ts, q_hs, ctx, c_bs, c_hs, c_ld, out, batch, heads, \
                               d, n, grid_x, round_bf16, scale, s)
  if (is_f32) {
    if (d <= 32) FT_PROJECT(float, 32);
    if (d <= 64) FT_PROJECT(float, 64);
    FT_PROJECT(float, 128);
  }
  if (d <= 32) FT_PROJECT(__nv_bfloat16, 32);
  if (d <= 64) FT_PROJECT(__nv_bfloat16, 64);
  FT_PROJECT(__nv_bfloat16, 128);
#undef FT_PROJECT
}

}  // extern "C"
