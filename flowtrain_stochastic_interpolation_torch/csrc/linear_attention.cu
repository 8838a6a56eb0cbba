// Folded linear attention, forward: the context kernel (K1) and the projection
// kernel (K2), written by hand for Hopper (sm_90a), with a plain C interface
// bound from Python through ctypes
// (flowtrain_stochastic_interpolation_torch/ops/linear_attention.py).
//
// Both work on the head-folded layout [B, N, h*d] with h = 4 heads of d = 32,
// so h*d = 128: the layout of the UNet's to_qkv projection, read in place
// through a token stride (q, k and v are column slices of one [B, N, 384]
// tensor; nothing is copied to make them contiguous).
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

}  // extern "C"
