// Linear attention, forward, written by hand for Hopper (sm_90a), with a plain
// C interface bound from Python through ctypes
// (flowtrain_stochastic_interpolation_torch/ops/linear_attention.py): the
// kernels specialised for 4 x 32 bf16 heads, first, which serve the folded
// context (K1) and projection (K2) of the flagship and, with their products
// kept at f32 accuracy, the v1 context (K4a) and projection (K4b); then the
// general path per (batch, head), which serves all four at every other head
// count, width and dtype (see its own note further down).
//
// The specialisation works on the head-folded layout [B, N, h*d] with h = 4
// heads of d = 32, so h*d = 128: the layout of the UNet's to_qkv projection,
// read in place through a token stride (q, k and v are column slices of one
// [B, N, 384] tensor; nothing is copied to make them contiguous). A
// contiguous [B, N, 128] tensor is read the same way, and so is the v1 path's
// [B, N, 4, 32] with the heads side by side: q a column slice of the [B, N,
// 3, 4, 32] projection, k and v the [B, 4 + N, 4, 32] concatenations with the
// memory tokens first.
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
// K4a replaces _context_kernel (called from _linear_attn_fwd_bhnd):
//     ctx = softmax over tokens of k, per column, ^T . v
// per (batch, head), [B, h, d, d] f32, with no memory seed (the memory tokens
// are the first rows of k and v) and every product in f32. K4b replaces
// _project_kernel:
//     out = softmax_d(q) * d^-1/2 @ ctx
// in f32, output in q's dtype. Where K1 and K2 round p (and ctx) to bf16, K4a
// and K4b split each f32 operand x into two bf16 terms, x_hi = bf16(x) and
// x_lo = bf16(x - x_hi), which carry x to within 2^-16 (bf16 keeps 8
// significant bits): K4a takes p.v as p_lo.v + p_hi.v (v is bf16, so exact),
// K4b takes p.ctx as p_lo.c_hi + p_hi.c_lo + p_hi.c_hi (the dropped p_lo.c_lo
// is within 2^-16 of it). The bf16 products are exact and their sums f32, on
// the tensor cores.
//
// Bound on the H100 (3.35 TB/s, 989 TFLOP/s bf16): at the flagship's largest
// call, 64^3 tokens x batch 8, K1 and K4a read k and v (2 x 537 MB) and K2
// and K4b read q and write out (2 x 537 MB). Each moves about 1.07 GB, 0.32 ms
// at the memory rate, against 17 GFLOP of products (0.02 ms at the bf16 rate;
// K4a's two and K4b's three bf16 products per f32 product, 0.04 and 0.05 ms)
// and 2.7e8 exponentials (0.07 ms on the special-function units): all four are
// bound by bytes, and the design is about keeping the stream at the memory
// rate with the products and exponentials hidden under it.
//
// What the design does about it (namespace k12 and the kernels below):
//   * The streams come by the Tensor Memory Accelerator. A producer warp asks
//     for each tile of 64 (K1, K4a) or 128 (K2, K4b) tokens x 128 columns as
//     two boxes of 64 columns (128-byte rows, the 128-byte swizzle, so
//     ldmatrix meets no bank conflict) of a 3-D tensor map over (column,
//     token, batch) that reads the operand in place through its token and
//     batch strides; tokens past n arrive as zeros. A ring of stages in shared
//     memory, each counted on an mbarrier (full: the TMA's bytes; empty: the
//     consumer warps' releases), keeps the next tiles in flight while the 8
//     consumer warps work; no __syncthreads paces the stream. The operands
//     stay bf16 in shared memory.
//   * The products run on the tensor cores (mma.sync.m16n8k16, bf16 operands,
//     f32 accumulation), which is exactly the TPU kernels' bf16 x bf16 -> f32
//     for K1 and K2, and f32 products to within 2^-16 through the split terms
//     for K4a and K4b. The softmax runs on the fragments: p is computed in f32
//     in the A registers and rounded (or split) to bf16 there; it never
//     touches shared memory.
//   * K1 and K4a (context_tiles): consumer warp w owns the 16 k columns 16w..
//     (head w / 2). A = p^T comes through ldmatrix.trans from the k tile; each
//     tile's column max is the max of the thread's fragment values and two
//     quad shuffles; the running max and sum update in registers, the [16,
//     32] f32 accumulator of the head's block is rescaled by exp(m_old -
//     m_new), and B = v comes through ldmatrix.trans. The TPU kernel carries
//     the online softmax across a sequential grid; on the card the blocks run
//     in parallel, so the context is two launches: a persistent partial pass,
//     one block per contiguous token range of one batch item (as many ranges
//     as fill the card once), that writes each range's m, s and four diagonal
//     [32, 32] blocks, and a combine that merges the ranges in order with the
//     exp(m_c - M) rescale (K1 seeds it with the memory tokens and writes the
//     zero-padded [128, 128] rows; K4a writes [h, d, d]); two launches give
//     identical outputs. At 64^3 b8 that is 264 slots of 17 KB, 0.4% of the
//     stream.
//   * K2 and K4b (project_tiles): a persistent grid walks 128-row tiles of
//     each batch item with ctx's four diagonal blocks staged once per block as
//     bf16 in shared memory (K4b: c_hi and c_lo); consumer warp w owns rows
//     16w.. of each tile and works head by head: q's A fragments through
//     ldmatrix, the group max and sum from the fragment and quad shuffles, p =
//     e / sum * d^-1/2 rounded (K4b: split) to bf16 in the A registers, 8
//     (K4b: 24) mma against ctx_h's B fragments (ldmatrix.trans). The bf16
//     output goes into the warp's own rows of the stage it read (q's head h
//     columns are consumed before head h's output lands there), then out in
//     16-byte runs; rows past n are never written. K4b's second copy of ctx
//     takes the room of a stage: it keeps two stages, so that two blocks
//     still fit on an SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "mma_async.cuh"

namespace {

constexpr int HD = 128;      // folded width h*d
constexpr int DH = 32;       // head width d
constexpr int NH = HD / DH;  // heads
constexpr int THREADS = 256;
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

namespace k12 {
constexpr int HALF = 64;                     // columns of one TMA box: a 128-byte row
constexpr int CONSUMERS = 8;                 // consumer warps
constexpr int NTHREADS = 32 * CONSUMERS + 32;  // + the producer warp
constexpr int CTX_TILE = 64, CTX_STAGES = 3;   // K1: tokens per stage, stages
constexpr int CTX_BOX = CTX_TILE * HALF;       // elements of one box
constexpr int CTX_STAGE = 4 * CTX_BOX;         // k's two halves, then v's
constexpr int PROJ_TILE = 16 * CONSUMERS, PROJ_STAGES = 3;  // K2: rows per stage, stages
constexpr int PROJ_BOX = PROJ_TILE * HALF;
constexpr int PROJ_STAGE = 2 * PROJ_BOX;       // q's two halves
constexpr int V1_PROJ_STAGES = 2;             // K4b: its c_lo takes the room of a stage
constexpr int LDC = DH + 8;                    // a staged ctx row: 5 16-byte units
constexpr int CTX_COPY = NH * DH * LDC;        // elements of one staged ctx
constexpr int ALIGN = 1024;                    // the swizzled boxes' alignment
constexpr int CTX_SMEM = ALIGN + CTX_STAGES * CTX_STAGE * 2;
// the ring and 1 (K2: c) or 2 (K4b: c_hi, c_lo) staged copies of ctx, in bytes
constexpr int proj_smem(int stages, int copies) {
  return ALIGN + (stages * PROJ_STAGE + copies * CTX_COPY) * 2;
}
constexpr int PROJ_SMEM = proj_smem(PROJ_STAGES, 1);
constexpr int V1_PROJ_SMEM = proj_smem(V1_PROJ_STAGES, 2);
constexpr float LOG2E = 1.4426950408889634f;

// the ring in dynamic shared memory, aligned for the 128-byte swizzle
__device__ __forceinline__ __nv_bfloat16* ring_base(unsigned char* raw) {
  const uint32_t base = mma_async::smem_addr(raw);
  return reinterpret_cast<__nv_bfloat16*>(raw + (ALIGN - base % ALIGN) % ALIGN);
}

// 16-byte unit u of row r of a box as the 128-byte swizzle lays it out
__device__ __forceinline__ int swz(int r, int u) { return r * HALF + ((u ^ (r & 7)) << 3); }

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// What pack_bf16(x0, x1) = hi dropped of x0 and x1, rounded to bf16 (exact
// differences, one rounding each): hi + lo carries each value to within 2^-16.
__device__ __forceinline__ uint32_t pack_bf16_rest(float x0, float x1, uint32_t hi) {
  return mma_async::pack_bf16(x0 - mma_async::low_f32(hi), x1 - mma_async::high_f32(hi));
}
}  // namespace k12

// ---------------------------------------------------------------------------
// K1 and K4a, pass 1: block (r, b) walks tiles r * range_tiles .. of batch
// item b and writes slot b * gridDim.x + r: the running column max m and sum s
// of its tokens and the four diagonal [32, 32] blocks of sum p^T v, with p =
// exp(k - m) rounded to bf16 in the product (K1) or split into p_hi + p_lo
// (SPLIT, K4a). A range with no token keeps m = -inf, s = 0 and ctx = 0, which
// the combine weighs as 0.
// ---------------------------------------------------------------------------
template <bool SPLIT>
__device__ __forceinline__ void context_tiles(const CUtensorMap& k_map, const CUtensorMap& v_map,
                                              int n, int range_tiles, float* __restrict__ part_m,
                                              float* __restrict__ part_s,
                                              float* __restrict__ part_ctx) {
  using namespace k12;
  using namespace mma_async;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[CTX_STAGES], empty[CTX_STAGES];
  __nv_bfloat16* ring = ring_base(smem_raw);
  const int r = blockIdx.x, b = blockIdx.y, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int first = r * range_tiles;
  const int count = max(0, min(range_tiles, (n + CTX_TILE - 1) / CTX_TILE - first));

  if (threadIdx.x == 0) {
    for (int j = 0; j < CTX_STAGES; ++j) {
      mbar_init(&full[j], 1);  // the producer's arrival with the boxes' bytes
      mbar_init(&empty[j], CONSUMERS);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == CONSUMERS) {  // the producer
    if (lane == 0) {
      for (int s = 0; s < count; ++s) {
        const int j = s % CTX_STAGES, pass = s / CTX_STAGES;
        if (pass > 0) mbar_wait(&empty[j], (pass - 1) & 1);  // the consumers are done with j
        __nv_bfloat16* st = ring + j * CTX_STAGE;
        const int tok = (first + s) * CTX_TILE;
        mbar_expect_tx(&full[j], CTX_STAGE * 2);
        tma_load_3d(st, &k_map, &full[j], 0, tok, b);
        tma_load_3d(st + CTX_BOX, &k_map, &full[j], HALF, tok, b);
        tma_load_3d(st + 2 * CTX_BOX, &v_map, &full[j], 0, tok, b);
        tma_load_3d(st + 3 * CTX_BOX, &v_map, &full[j], HALF, tok, b);
      }
    }
    return;
  }

  // Fragments (mma_async.cuh's layout, g = lane / 4, q = lane % 4). A = p^T:
  // a0, a2 hold column 16 warp + g, a1, a3 column 16 warp + g + 8, at tokens
  // 2q, 2q + 1 (+ 8 for a2, a3) of the k-step; ldmatrix matrix mi takes
  // columns + 8 (mi & 1) and tokens + 8 (mi >> 1) of the stored k tile. B = v:
  // matrix mi takes tokens + 8 (mi & 1) and columns + 8 (mi >> 1) of a pair
  // of n8 tiles of the head's 32 columns.
  const int g = lane >> 2, q = lane & 3, mi = lane >> 3, mr = lane & 7;
  const int h = warp >> 1;
  const int k_box = (warp >> 2) * CTX_BOX, a_unit = 2 * (warp & 3) + (mi & 1);
  const int a_tok = mr + 8 * (mi >> 1);
  const int v_box = (2 + (h >> 1)) * CTX_BOX, b_unit = 4 * (h & 1) + (mi >> 1);
  const int b_tok = mr + 8 * (mi & 1);

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  float m_run[2] = {neg_inf(), neg_inf()}, s_run[2] = {0.f, 0.f};  // columns g, g + 8

  for (int s = 0; s < count; ++s) {
    const int j = s % CTX_STAGES;
    mbar_wait(&full[j], (s / CTX_STAGES) & 1);  // tile s has landed
    const __nv_bfloat16* st = ring + j * CTX_STAGE;

    uint32_t a[4][4];
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      ldmatrix_x4_trans(a[ks], st + k_box + swz(16 * ks + a_tok, a_unit));
    float x[4][4][2];
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        x[ks][i][0] = low_f32(a[ks][i]);
        x[ks][i][1] = high_f32(a[ks][i]);
      }
    const int tok0 = (first + s) * CTX_TILE;
    if (tok0 + CTX_TILE > n) {  // the last tile: tokens past n (zeros from the TMA) are -inf
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (tok0 + 16 * ks + 8 * (i >> 1) + 2 * q + e >= n) x[ks][i][e] = neg_inf();
    }

    float mx[2] = {neg_inf(), neg_inf()};
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
#pragma unroll
      for (int i = 0; i < 4; ++i) mx[i & 1] = fmaxf(mx[i & 1], fmaxf(x[ks][i][0], x[ks][i][1]));
    float shift[2], alpha[2];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const float m_new = fmaxf(m_run[c], quad_max(mx[c]));
      // a column with no finite key so far keeps m = -inf: shift by 0 there,
      // so that its exponentials are 0 and never exp(-inf - (-inf)) = NaN
      shift[c] = m_new == neg_inf() ? 0.f : m_new * LOG2E;
      alpha[c] = exp2_approx(fmaf(m_run[c], LOG2E, -shift[c]));  // 0 on the first tile
      m_run[c] = m_new;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      acc[i][0] *= alpha[0];
      acc[i][1] *= alpha[0];
      acc[i][2] *= alpha[1];
      acc[i][3] *= alpha[1];
    }
    float psum[2] = {0.f, 0.f};
    uint32_t lo[SPLIT ? 4 : 1][4];  // K4a: p - p_hi in bf16
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p0 = exp2_approx(fmaf(x[ks][i][0], LOG2E, -shift[i & 1]));
        const float p1 = exp2_approx(fmaf(x[ks][i][1], LOG2E, -shift[i & 1]));
        psum[i & 1] += p0 + p1;        // the sum takes exp in f32
        a[ks][i] = pack_bf16(p0, p1);  // the product takes it in bf16 (K4a: p_hi)
        if constexpr (SPLIT) lo[ks][i] = pack_bf16_rest(p0, p1, a[ks][i]);
      }
#pragma unroll
    for (int c = 0; c < 2; ++c) s_run[c] = fmaf(s_run[c], alpha[c], psum[c]);

#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, st + v_box + swz(16 * ks + b_tok, b_unit + 2 * p));
        if constexpr (SPLIT) {  // the small term first
          mma(acc[2 * p], lo[ks], bv[0], bv[1]);
          mma(acc[2 * p + 1], lo[ks], bv[2], bv[3]);
        }
        mma(acc[2 * p], a[ks], bv[0], bv[1]);
        mma(acc[2 * p + 1], a[ks], bv[2], bv[3]);
      }
    // this warp's reads of stage j (the generic proxy) ordered before the TMA
    // (the async proxy) refills it. Without the fence a refill could land before
    // the reads were done: now and then a launch returned other bits for the same
    // operands (tools/sde_repro.py, its k1 round)
    fence_proxy_async();
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[j]);  // this warp is done with stage j
  }

  // each lane summed its own tokens; the quad holds the column's four parts
  const long long slot = (long long)b * gridDim.x + r;
  const int col = 16 * warp + g;
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const float s_col = quad_sum(s_run[c]);
    if (q == 0) {
      part_m[slot * HD + col + 8 * c] = m_run[c];
      part_s[slot * HD + col + 8 * c] = s_col;
    }
  }
  float* pc = part_ctx + (slot * NH + h) * DH * DH;
  const int d0 = 16 * (warp & 1) + g;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int e = 8 * i + 2 * q;
    *reinterpret_cast<float2*>(&pc[d0 * DH + e]) = make_float2(acc[i][0], acc[i][1]);
    *reinterpret_cast<float2*>(&pc[(d0 + 8) * DH + e]) = make_float2(acc[i][2], acc[i][3]);
  }
}

__global__ void __launch_bounds__(k12::NTHREADS, 2)
folded_context_partial(const __grid_constant__ CUtensorMap k_map,
                       const __grid_constant__ CUtensorMap v_map, int n, int range_tiles,
                       float* __restrict__ part_m, float* __restrict__ part_s,
                       float* __restrict__ part_ctx) {
  context_tiles<false>(k_map, v_map, n, range_tiles, part_m, part_s, part_ctx);
}

__global__ void __launch_bounds__(k12::NTHREADS, 2)
linear_context_partial(const __grid_constant__ CUtensorMap k_map,
                       const __grid_constant__ CUtensorMap v_map, int n, int range_tiles,
                       float* __restrict__ part_m, float* __restrict__ part_s,
                       float* __restrict__ part_ctx) {
  context_tiles<true>(k_map, v_map, n, range_tiles, part_m, part_s, part_ctx);
}

// ---------------------------------------------------------------------------
// K1 and K4a, pass 2: per (head, 8-row slab, batch) merge of the ranges' slots
// in order, seeded with the n_mem memory tokens (K1; none for K4a), divided by
// the column sums. FOLDED (K1) writes the full [128, 128] rows with zeros off
// the head's diagonal block; else (K4a) the head's [32, 32] block of [B, h, d, d].
// ---------------------------------------------------------------------------
template <bool FOLDED>
__device__ __forceinline__ void combine_slots(const float* __restrict__ part_m,
                                              const float* __restrict__ part_s,
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

  if constexpr (FOLDED) {
    float* row = ctx + ((long long)b * HD + kc) * HD;
#pragma unroll
    for (int hh = 0; hh < NH; ++hh) row[hh * DH + e] = (hh == h) ? acc / s : 0.f;
  } else {
    ctx[(((long long)b * NH + h) * DH + d) * DH + e] = acc / s;
  }
}

__global__ void __launch_bounds__(THREADS)
folded_context_combine(const float* __restrict__ part_m, const float* __restrict__ part_s,
                       const float* __restrict__ part_ctx,
                       const __nv_bfloat16* __restrict__ mem_k,
                       const __nv_bfloat16* __restrict__ mem_v, int n_mem,
                       int n_chunks, float* __restrict__ ctx) {
  combine_slots<true>(part_m, part_s, part_ctx, mem_k, mem_v, n_mem, n_chunks, ctx);
}

__global__ void __launch_bounds__(THREADS)
linear_context_combine(const float* __restrict__ part_m, const float* __restrict__ part_s,
                       const float* __restrict__ part_ctx, int n_chunks,
                       float* __restrict__ ctx) {
  combine_slots<false>(part_m, part_s, part_ctx, nullptr, nullptr, 0, n_chunks, ctx);
}

// ---------------------------------------------------------------------------
// K2 and K4b: out = groupsoftmax(q) * scale @ ctx. Block (x, b) walks the
// 128-row tiles x, x + gridDim.x, ... of batch item b through a ring of
// STAGES; ctx's diagonal blocks are staged once, rounded to bf16 (K2: ctx
// [B, 128, 128]) or split into c_hi and c_lo (SPLIT, K4b: ctx [B, 4, 32, 32]),
// and p is rounded (K2) or split into p_hi + p_lo (K4b).
// ---------------------------------------------------------------------------
template <bool SPLIT, int STAGES>
__device__ __forceinline__ void project_tiles(const CUtensorMap& q_map,
                                              const float* __restrict__ ctx,
                                              __nv_bfloat16* __restrict__ out, int n,
                                              float scale) {
  using namespace k12;
  using namespace mma_async;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  __nv_bfloat16* ring = ring_base(smem_raw);
  __nv_bfloat16* ctx_s = ring + STAGES * PROJ_STAGE;  // [NH][DH][LDC]: c, or c_hi
  __nv_bfloat16* ctx_lo = ctx_s + CTX_COPY;           // K4b: c_lo
  const int b = blockIdx.y, t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int tiles = (n + PROJ_TILE - 1) / PROJ_TILE;
  const int mine = tiles > static_cast<int>(blockIdx.x)
                       ? (tiles - 1 - static_cast<int>(blockIdx.x)) / gridDim.x + 1 : 0;

  if (t == 0) {
    for (int j = 0; j < STAGES; ++j) {
      mbar_init(&full[j], 1);
      mbar_init(&empty[j], CONSUMERS);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == CONSUMERS) {  // the producer
    if (lane == 0) {
      for (int s = 0; s < mine; ++s) {
        const int j = s % STAGES, pass = s / STAGES;
        if (pass > 0) mbar_wait(&empty[j], (pass - 1) & 1);
        __nv_bfloat16* st = ring + j * PROJ_STAGE;
        const int row0 = (blockIdx.x + s * gridDim.x) * PROJ_TILE;
        mbar_expect_tx(&full[j], PROJ_STAGE * 2);
        tma_load_3d(st, &q_map, &full[j], 0, row0, b);
        tma_load_3d(st + PROJ_BOX, &q_map, &full[j], HALF, row0, b);
      }
    }
    return;
  }

  const float* cb = ctx + (long long)b * (SPLIT ? NH * DH * DH : HD * HD);
  for (int i = t; i < NH * DH * DH; i += 32 * CONSUMERS) {
    const int hh = i / (DH * DH), d = (i / DH) % DH, e = i % DH;
    const float c = SPLIT ? cb[i] : cb[(hh * DH + d) * HD + hh * DH + e];
    const __nv_bfloat16 hi = __float2bfloat16(c);
    const int at = (hh * DH + d) * LDC + e;
    ctx_s[at] = hi;
    if constexpr (SPLIT) ctx_lo[at] = __float2bfloat16(c - __bfloat162float(hi));
  }
  bar_sync(1, 32 * CONSUMERS);  // ctx_s is staged

  // Fragments: A = p, rows 16 warp + g (a0, a2) and + 8 (a1, a3); ldmatrix
  // matrix mi takes rows + 8 (mi & 1) and columns + 8 (mi >> 1) of a k16 step.
  // B = ctx_h [d, e]: matrix mi takes d + 8 (mi & 1) and e + 8 (mi >> 1) of a
  // pair of n8 tiles.
  const int g = lane >> 2, q = lane & 3, mi = lane >> 3, mr = lane & 7;
  const int row_w = 16 * warp, a_row = row_w + mr + 8 * (mi & 1);
  const int b_off = (mr + 8 * (mi & 1)) * LDC + 8 * (mi >> 1);
  __nv_bfloat16* ob = out + (long long)b * n * HD;

  for (int s = 0; s < mine; ++s) {
    const int j = s % STAGES;
    mbar_wait(&full[j], (s / STAGES) & 1);
    __nv_bfloat16* st = ring + j * PROJ_STAGE;
    const int row0 = (blockIdx.x + s * gridDim.x) * PROJ_TILE;
#pragma unroll
    for (int h = 0; h < NH; ++h) {
      __nv_bfloat16* qh = st + (h >> 1) * PROJ_BOX;  // head h: units 4 (h % 2).. of its box
      uint32_t a[2][4];
#pragma unroll
      for (int ks = 0; ks < 2; ++ks)
        ldmatrix_x4(a[ks], qh + swz(a_row, 4 * (h & 1) + 2 * ks + (mi >> 1)));
      float x[2][4][2];
      float mx[2] = {neg_inf(), neg_inf()};  // rows g, g + 8
#pragma unroll
      for (int ks = 0; ks < 2; ++ks)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          x[ks][i][0] = low_f32(a[ks][i]);
          x[ks][i][1] = high_f32(a[ks][i]);
          mx[i & 1] = fmaxf(mx[i & 1], fmaxf(x[ks][i][0], x[ks][i][1]));
        }
      float shift[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int c = 0; c < 2; ++c) shift[c] = quad_max(mx[c]) * LOG2E;  // the head's max
#pragma unroll
      for (int ks = 0; ks < 2; ++ks)
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            x[ks][i][e] = exp2_approx(fmaf(x[ks][i][e], LOG2E, -shift[i & 1]));
            sum[i & 1] += x[ks][i][e];
          }
      float f[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) f[c] = scale / quad_sum(sum[c]);
      uint32_t lo[SPLIT ? 2 : 1][4];  // K4b: p - p_hi in bf16
#pragma unroll
      for (int ks = 0; ks < 2; ++ks)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p0 = x[ks][i][0] * f[i & 1], p1 = x[ks][i][1] * f[i & 1];
          a[ks][i] = pack_bf16(p0, p1);
          if constexpr (SPLIT) lo[ks][i] = pack_bf16_rest(p0, p1, a[ks][i]);
        }

      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
      const __nv_bfloat16* ch = ctx_s + h * DH * LDC + b_off;
#pragma unroll
      for (int ks = 0; ks < 2; ++ks)
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          uint32_t bc[4];
          ldmatrix_x4_trans(bc, ch + 16 * ks * LDC + 16 * p);
          if constexpr (SPLIT) {  // the small terms first: p_lo.c_hi, p_hi.c_lo
            uint32_t cl[4];
            ldmatrix_x4_trans(cl, ch + CTX_COPY + 16 * ks * LDC + 16 * p);
            mma(acc[2 * p], lo[ks], bc[0], bc[1]);
            mma(acc[2 * p + 1], lo[ks], bc[2], bc[3]);
            mma(acc[2 * p], a[ks], cl[0], cl[1]);
            mma(acc[2 * p + 1], a[ks], cl[2], cl[3]);
          }
          mma(acc[2 * p], a[ks], bc[0], bc[1]);
          mma(acc[2 * p + 1], a[ks], bc[2], bc[3]);
        }
      __syncwarp();  // every lane has read head h's q: its output may take its place
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int u = 4 * (h & 1) + i;
        *reinterpret_cast<uint32_t*>(qh + swz(row_w + g, u) + 2 * q) =
            pack_bf16(acc[i][0], acc[i][1]);
        *reinterpret_cast<uint32_t*>(qh + swz(row_w + g + 8, u) + 2 * q) =
            pack_bf16(acc[i][2], acc[i][3]);
      }
    }
    __syncwarp();
    // the warp's 16 output rows, 16-byte runs: two rows of 256 bytes per step
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int rr = 2 * i + (lane >> 4), u = lane & 15, row = row0 + row_w + rr;
      if (row < n)
        *reinterpret_cast<uint4*>(ob + (long long)row * HD + 8 * u) =
            *reinterpret_cast<const uint4*>(st + (u >> 3) * PROJ_BOX + swz(row_w + rr, u & 7));
    }
    fence_proxy_async();  // these accesses before the TMA refills the stage
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[j]);
  }
}

__global__ void __launch_bounds__(k12::NTHREADS, 2)
folded_project(const __grid_constant__ CUtensorMap q_map, const float* __restrict__ ctx,
               __nv_bfloat16* __restrict__ out, int n, float scale) {
  project_tiles<false, k12::PROJ_STAGES>(q_map, ctx, out, n, scale);
}

__global__ void __launch_bounds__(k12::NTHREADS, 2)
linear_project_tiles(const __grid_constant__ CUtensorMap q_map, const float* __restrict__ ctx,
                     __nv_bfloat16* __restrict__ out, int n, float scale) {
  project_tiles<true, k12::V1_PROJ_STAGES>(q_map, ctx, out, n, scale);
}

// ===========================================================================
// The general path: one (batch, head) pair per block row of the grid, any
// number of heads, any head width d with d % 8 == 0, bf16 or f32 operands,
// each read in place through its batch, token and head strides.
//
// It serves the four kernels beyond the 4 x 32 bf16 specialisation above:
//   * K1 and K2 (folded layout [B, N, h*d], head stride d; K1 keeps only the
//     per-head diagonal blocks, which is exactly a per-(batch, head) context;
//     round_bf16 = 1);
//   * K4a and K4b, the v1 linear attention (see the note at the top), with
//     no memory-token seed and everything in f32 on the FP32 cores, output in
//     q's dtype (round_bf16 = 0); in f32, at other head counts or widths, or
//     with the heads not side by side. q is read from the [B, N, 3, h, d]
//     projection and k, v from the [B, M, h, d] concatenations in place: the
//     TPU's [B*h, N, d] transposes are gone.
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
// Bound on the H100: at b8 x 64^3 with 4 heads x 32 (which the specialisation
// serves in bf16), the context reads k and v (2 x 537 MB in bf16) and the
// projection reads q and writes out: about 0.32 ms each at 3.35 TB/s (twice
// that in f32), against 17 GFLOP of f32 products (0.26 ms at the 67 TFLOP/s
// of the FP32 cores): memory-bound, with the products close behind.
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
  static bool sized[mma_async::MAX_DEVICES] = {};  // above 48 KB once allowed, per device
  const int code = mma_async::allow_smem(reinterpret_cast<const void*>(project_general<T, DB>),
                                         S::SMEM, sized);
  if (code != 0) return code;
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

// ---------------------------------------------------------------------------
// Launching K1, K2, K4a and K4b on 4 x 32 bf16
// ---------------------------------------------------------------------------
constexpr int MAX_DEVICES = 64;

// Blocks of `kernel` resident on the card at once (SMs x blocks per SM at
// `smem` bytes of dynamic shared memory), found once per device into the
// caller's `cache`, after the kernel is allowed that much shared memory.
// Returns 0 or a CUDA error code.
int card_blocks(const void* kernel, int smem, int (&cache)[MAX_DEVICES], int* blocks) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device < MAX_DEVICES && cache[device]) {
    *blocks = cache[device];
    return 0;
  }
  int sms = 0, per_sm = 0;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, k12::NTHREADS, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  *blocks = sms * std::max(per_sm, 1);
  if (device < MAX_DEVICES) cache[device] = *blocks;
  return 0;
}

// [batch, n, 128] bf16 read through its token and batch strides (elements)
// as a tensor map over (column, token, batch) in boxes of 64 columns x `rows`
// tokens. Returns 0 or a CUDA error code.
int folded_map(CUtensorMap* map, const void* t, long long ld, long long bs, int batch, int n,
               int rows) {
  // a batch of one never steps along its batch stride, which may be anything
  const long long batch_stride = batch > 1 ? bs : ld * n;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(HD), static_cast<cuuint64_t>(n),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(ld) * 2,
                                 static_cast<cuuint64_t>(batch_stride) * 2};
  const cuuint32_t box[3] = {k12::HALF, static_cast<cuuint32_t>(rows), 1};
  return mma_async::bf16_tensor_map(map, t, 3, dims, strides, box);
}

// The token ranges of K1 (K4a with SPLIT): each block walks range_tiles tiles
// of 64 tokens of one batch item, and the ranges of all batch items fill the
// card once.
template <bool SPLIT>
int context_ranges(int batch, int n, int* range_tiles, int* slots) {
  static int cache[MAX_DEVICES] = {};
  int blocks = 0;
  const void* kernel = SPLIT ? reinterpret_cast<const void*>(linear_context_partial)
                             : reinterpret_cast<const void*>(folded_context_partial);
  const int err = card_blocks(kernel, k12::CTX_SMEM, cache, &blocks);
  if (err) return err;
  const long long tiles = (n + k12::CTX_TILE - 1) / k12::CTX_TILE;
  const long long per_range = (tiles * batch + blocks - 1) / blocks;
  *range_tiles = static_cast<int>(per_range > 0 ? per_range : 1);
  *slots = static_cast<int>((tiles + *range_tiles - 1) / *range_tiles);
  return 0;
}

}  // namespace

extern "C" {

// K1 on 4 x 32 bf16: the partial slots per batch item that
// folded_context_forward uses for this shape (its scratch is sized by them),
// or -1 with *err set to a CUDA error code.
int folded_context_slots(int batch, int n, int* err) {
  int range_tiles = 0, slots = 0;
  *err = batch < 1 || n < 1 ? static_cast<int>(cudaErrorInvalidValue)
                            : context_ranges<false>(batch, n, &range_tiles, &slots);
  return *err ? -1 : slots;
}

// K1: ctx [batch, 128, 128] f32 from k, v [batch, n, 128] bf16 (token stride
// k_ld / v_ld elements, batch stride k_bs / v_bs, all multiples of 8, rows
// 16-byte aligned) and mem_k, mem_v [n_mem, 128] bf16. part_m, part_s [batch,
// slots, 128] and part_ctx [batch, slots, 4, 32, 32] f32 are scratch, with
// slots from folded_context_slots. Returns cudaGetLastError() after the two
// launches, or the error of a tensor map the TMA cannot take.
int folded_context_forward(const void* k, const void* v, long long k_ld, long long v_ld,
                           long long k_bs, long long v_bs, const void* mem_k,
                           const void* mem_v, int n_mem, int batch, int n, void* part_m,
                           void* part_s, void* part_ctx, void* ctx, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch < 1 || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  int range_tiles = 0, slots = 0;
  int err = context_ranges<false>(batch, n, &range_tiles, &slots);
  CUtensorMap k_map, v_map;
  if (!err) err = folded_map(&k_map, k, k_ld, k_bs, batch, n, k12::CTX_TILE);
  if (!err) err = folded_map(&v_map, v, v_ld, v_bs, batch, n, k12::CTX_TILE);
  if (err) return err;
  folded_context_partial<<<dim3(slots, batch), k12::NTHREADS, k12::CTX_SMEM, s>>>(
      k_map, v_map, n, range_tiles, static_cast<float*>(part_m), static_cast<float*>(part_s),
      static_cast<float*>(part_ctx));
  const cudaError_t launched = cudaGetLastError();
  if (launched != cudaSuccess) return static_cast<int>(launched);
  folded_context_combine<<<dim3(NH * (DH / COMBINE_ROWS), batch), THREADS, 0, s>>>(
      static_cast<const float*>(part_m), static_cast<const float*>(part_s),
      static_cast<const float*>(part_ctx), static_cast<const __nv_bfloat16*>(mem_k),
      static_cast<const __nv_bfloat16*>(mem_v), n_mem, slots, static_cast<float*>(ctx));
  return static_cast<int>(cudaGetLastError());
}

// K2: out [batch, n, 128] bf16 (contiguous) from q [batch, n, 128] bf16
// (token stride q_ld, batch stride q_bs, multiples of 8, rows 16-byte aligned)
// and ctx [batch, 128, 128] f32. Returns cudaGetLastError() after the launch,
// or the error of a tensor map the TMA cannot take.
int folded_project_forward(const void* q, long long q_ld, long long q_bs, const void* ctx,
                           void* out, int batch, int n, float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch < 1 || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  static int cache[MAX_DEVICES] = {};
  int blocks = 0;
  int err = card_blocks(reinterpret_cast<const void*>(folded_project), k12::PROJ_SMEM, cache,
                        &blocks);
  CUtensorMap q_map;
  if (!err) err = folded_map(&q_map, q, q_ld, q_bs, batch, n, k12::PROJ_TILE);
  if (err) return err;
  // as many blocks per batch item as fill the card once, at most one per tile
  const int tiles = (n + k12::PROJ_TILE - 1) / k12::PROJ_TILE;
  const int per_item = std::max(1, std::min(tiles, (blocks + batch - 1) / batch));
  folded_project<<<dim3(per_item, batch), k12::NTHREADS, k12::PROJ_SMEM, s>>>(
      q_map, static_cast<const float*>(ctx), static_cast<__nv_bfloat16*>(out), n, scale);
  return static_cast<int>(cudaGetLastError());
}

// K4a on 4 x 32 bf16: the partial slots per batch item that
// linear_context_forward uses for this shape, or -1 with *err set to a CUDA
// error code.
int linear_context_slots(int batch, int n, int* err) {
  int range_tiles = 0, slots = 0;
  *err = batch < 1 || n < 1 ? static_cast<int>(cudaErrorInvalidValue)
                            : context_ranges<true>(batch, n, &range_tiles, &slots);
  return *err ? -1 : slots;
}

// K4a: ctx [batch, 4, 32, 32] f32 from k, v [batch, n, 4, 32] bf16 with the
// heads side by side (token stride k_ld / v_ld elements, batch stride k_bs /
// v_bs, all multiples of 8, rows 16-byte aligned). part_m, part_s [batch,
// slots, 128] and part_ctx [batch, slots, 4, 32, 32] f32 are scratch, with
// slots from linear_context_slots. Returns cudaGetLastError() after the two
// launches, or the error of a tensor map the TMA cannot take.
int linear_context_forward(const void* k, const void* v, long long k_ld, long long v_ld,
                           long long k_bs, long long v_bs, int batch, int n, void* part_m,
                           void* part_s, void* part_ctx, void* ctx, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch < 1 || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  int range_tiles = 0, slots = 0;
  int err = context_ranges<true>(batch, n, &range_tiles, &slots);
  CUtensorMap k_map, v_map;
  if (!err) err = folded_map(&k_map, k, k_ld, k_bs, batch, n, k12::CTX_TILE);
  if (!err) err = folded_map(&v_map, v, v_ld, v_bs, batch, n, k12::CTX_TILE);
  if (err) return err;
  linear_context_partial<<<dim3(slots, batch), k12::NTHREADS, k12::CTX_SMEM, s>>>(
      k_map, v_map, n, range_tiles, static_cast<float*>(part_m), static_cast<float*>(part_s),
      static_cast<float*>(part_ctx));
  const cudaError_t launched = cudaGetLastError();
  if (launched != cudaSuccess) return static_cast<int>(launched);
  linear_context_combine<<<dim3(NH * (DH / COMBINE_ROWS), batch), THREADS, 0, s>>>(
      static_cast<const float*>(part_m), static_cast<const float*>(part_s),
      static_cast<const float*>(part_ctx), slots, static_cast<float*>(ctx));
  return static_cast<int>(cudaGetLastError());
}

// K4b: out [batch, n, 4, 32] bf16 (contiguous) from q [batch, n, 4, 32] bf16
// with the heads side by side (token stride q_ld, batch stride q_bs,
// multiples of 8, rows 16-byte aligned) and ctx [batch, 4, 32, 32] f32.
// Returns cudaGetLastError() after the launch, or the error of a tensor map
// the TMA cannot take.
int linear_project_forward(const void* q, long long q_ld, long long q_bs, const void* ctx,
                           void* out, int batch, int n, float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch < 1 || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  static int cache[MAX_DEVICES] = {};
  int blocks = 0;
  int err = card_blocks(reinterpret_cast<const void*>(linear_project_tiles), k12::V1_PROJ_SMEM,
                        cache, &blocks);
  CUtensorMap q_map;
  if (!err) err = folded_map(&q_map, q, q_ld, q_bs, batch, n, k12::PROJ_TILE);
  if (err) return err;
  const int tiles = (n + k12::PROJ_TILE - 1) / k12::PROJ_TILE;
  const int per_item = std::max(1, std::min(tiles, (blocks + batch - 1) / batch));
  linear_project_tiles<<<dim3(per_item, batch), k12::NTHREADS, k12::V1_PROJ_SMEM, s>>>(
      q_map, static_cast<const float*>(ctx), static_cast<__nv_bfloat16*>(out), n, scale);
  return static_cast<int>(cudaGetLastError());
}

// The general context (K1 and K4a beyond 4 x 32 bf16): ctx from k, v
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

// The general projection (K2 and K4b beyond 4 x 32 bf16): out [batch, n,
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
