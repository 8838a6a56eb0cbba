// The GEMM probes behind the tap-folded conv, written by hand for Hopper
// (sm_90a), with a plain C interface bound from Python through ctypes
// (flowtrain_stochastic_interpolation_torch/ops/gemm_probes.py).
//
// P1 replaces tools/bench_pallas_gemm.py _mm_kernel / pallas_mm and
// _mm_kernel_t / pallas_mm_t: out = bf16(A B) for A [M, K] and B [K, N], in
// two output layouts, [M, N] and its transpose [N, M] (the TPU's "M on
// lanes" variant, which takes B transposed, Bt [N, K]). B is read as (k, n)
// at b + k b_ks + n b_ns and out is written at out + m o_ms + n o_ns.
// Bound on the H100 at the probe's shape 524,288 x 1296 x 48: A is 1.36 GB,
// read once, against 6.5e10 operations: 0.42 ms at 3.35 TB/s and 0.07 ms at
// 989 TFLOP/s, so P1 is bound by bytes, and its design is about keeping A's
// stream at the memory rate. Two kernels, chosen by gemm_probe_forward from
// the shapes (stream_path): gemm_stream (below) for K and N multiples of 8
// with N <= 128 and the two contiguous layouts, every shape of the tools;
// gemm_p1, the block-tile GEMM of csrc/tile_mma.cuh (128 x 64 tiles, any
// strides), for the rest.
//
// P2 replaces tools/bench_mxu_shapes.py _make_probe_kernel (called from
// _run): for A [grid, m_block + 256, K] and B [K, N],
//     out[m, n] = bf16( max(0, max over g < grid, i < R of
//                              A[g, 8 (i mod 32) + m, :] . B[:, n]) ),
// R products per grid step over row windows that slide by 8, max-accumulated
// so that no product can be folded into another. Every one of the R products
// is computed: a kernel that noticed that only 32 windows differ would void
// the probe. Its purpose is the tensor-core rate at each (K, N) with the
// operands kept on chip as far as a block can hold them. On the TPU the whole
// [m_block + 256, K] block of A sits in VMEM and each window is a free offset
// slice of it.
// What bounds it on the H100: operations. At (2048, 1296, 48, 16) with R = 256
// the products are 1.04e12 operations, 1.0553 ms at 989 TFLOP/s, against
// 0.1 GB of A and B read once (0.03 ms at 3.35 TB/s).
// Where L2 would bind: a window of 128 rows does not fit in shared memory with
// its 248 rows of slide (975 KB at K = 1296), so windows come from L2. Read
// anew for each product, A is 21.7 GB per call at that case: 20 TB/s at the
// bound, several times what L2 delivers. At N = 48 each byte of a window
// carries only 48 operations.
// The window path (probe_windows, below) does three things about it:
//   * Slabs. The W = 8 consecutive windows of a pass over one 64-row output
//     tile all lie in one slab of 64 + 8 (W - 1) = 120 rows; each 64-k slice
//     of the slab comes into shared memory once and feeds the W products, each
//     into its own accumulator, so each L2 byte carries W times more
//     operations (5.3 GB of L2 reads at that case). Every product is still
//     computed: a pass shares loads, never products.
//   * The slabs come by the TMA into a ring of mbarrier-counted stages from
//     one producer warp, and persistent blocks walk the (column tile, grid
//     step, row tile) items, so loads run ahead of the products and a tile's
//     epilogue overlaps the next tile's first loads. B [K, N tile] stays in
//     shared memory, staged once per block (again only when the column tile
//     changes), transposed to K-major 64-k slices with the 128-byte swizzle.
//   * The products run on wgmma (m64n48k16 or m64n64k16, both operands from
//     shared memory): window w of the slab starts w 8-row atoms (w x 1024
//     bytes) after the slab, so its descriptor is the slab's plus w x 1024.
//     Two consumer warpgroups split the W windows (window w to warpgroup
//     w % 2) and keep one group of products in flight while the next slice
//     is issued.
// The max over the grid steps and the warpgroups is an integer atomicMax on
// the bits of non-negative floats into an f32 [m_block, N] buffer (exact in
// any order, so every launch gives the same output), then one pass rounds it
// to bf16. Shapes the window path does not take (K not a multiple of 8, which
// the TMA's row stride needs) run probe_partial, one block per (grid step,
// 128 rows, 64 columns) on csrc/tile_mma.cuh, and the combine pass.

#include <cuda.h>
#include <stdint.h>

#include <algorithm>

#include "mma_async.cuh"
#include "tile_mma.cuh"

namespace {

using namespace tile;
using bf16 = __nv_bfloat16;
using S = Shape<bf16>;

constexpr int P2_PAD = 32 * 8;   // rows of slide below each grid step's m_block rows
constexpr int P2_MAX_K = 1600;   // the [K, 64] B tile must fit in shared memory

// P1, any shape: one block per 128 rows x 64 columns of A B.
__global__ void __launch_bounds__(THREADS)
gemm_p1(const bf16* __restrict__ a, const bf16* __restrict__ b, long long b_ks, long long b_ns,
        bf16* __restrict__ out, long long o_ms, long long o_ns, int M, int N, int K) {
  __shared__ __align__(16) bf16 a_s[BM * S::LD];
  __shared__ __align__(16) bf16 b_s[BN * S::LD];
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  Acc acc;
  zero(acc);
  const WarpPos wp;
  for (int kb = 0; kb < K; kb += S::BK) {
    const int kn = min(S::BK, K - kb);
    __syncthreads();  // the previous slice is consumed
    stage<bf16, BM>(a_s, S::LD, a + static_cast<long long>(m0) * K + kb, K, 1, M - m0, kn, true);
    stage<bf16, BN>(b_s, S::LD, b + kb * b_ks + n0 * b_ns, b_ns, b_ks, N - n0, kn,
                    (kb * b_ks + n0 * b_ns) % 8 == 0);
    __syncthreads();
    warp_tile<bf16>(acc, a_s + wp.row0 * S::LD, S::LD, b_s + wp.col0 * S::LD, S::LD, kn);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = m0 + wp.row(i, e), col = n0 + wp.col(j, e);
        if (row < M && col < N) out[row * o_ms + col * o_ns] = __float2bfloat16(acc[i][j][e]);
      }
}

// P2, pass 1: one block per (grid step, 128 rows of the window, 64 columns):
// the max over its R products, floored at 0, to its own slot of part [grid,
// m_block, N] f32. Shared memory: the A slice, then B's [K, 64] columns.
__global__ void __launch_bounds__(THREADS)
probe_partial(const bf16* __restrict__ a, const bf16* __restrict__ b, float* __restrict__ part,
              int m_block, int K, int N, int reps, int ldb) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* a_s = reinterpret_cast<bf16*>(smem);
  bf16* b_s = a_s + BM * S::LD;
  const int step = blockIdx.x, m0 = blockIdx.y * BM, n0 = blockIdx.z * BN;
  const bf16* a_step = a + static_cast<long long>(step) * (m_block + P2_PAD) * K;

  for (int kb = 0; kb < K; kb += S::BK)  // B's columns n0.., transposed, once
    stage<bf16, BN>(b_s + kb, ldb, b + static_cast<long long>(kb) * N + n0, 1, N, N - n0,
                    min(S::BK, K - kb), N % 8 == 0);

  Acc best;
  zero(best);  // the TPU kernel's zero-initialised max
  const WarpPos wp;
  for (int i = 0; i < reps; ++i) {
    const bf16* window = a_step + static_cast<long long>(8 * (i % 32) + m0) * K;
    Acc acc;
    zero(acc);
    for (int kb = 0; kb < K; kb += S::BK) {
      const int kn = min(S::BK, K - kb);
      __syncthreads();  // B is staged, or the previous slice is consumed
      stage<bf16, BM>(a_s, S::LD, window + kb, K, 1, m_block - m0, kn, K % 8 == 0);
      __syncthreads();
      warp_tile<bf16>(acc, a_s + wp.row0 * S::LD, S::LD, b_s + wp.col0 * ldb + kb, ldb, kn);
    }
#pragma unroll
    for (int ii = 0; ii < 2; ++ii)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) best[ii][j][e] = fmaxf(best[ii][j][e], acc[ii][j][e]);
  }

  float* slot = part + static_cast<long long>(step) * m_block * N;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = m0 + wp.row(i, e), col = n0 + wp.col(j, e);
        if (row < m_block && col < N) slot[static_cast<long long>(row) * N + col] = best[i][j][e];
      }
}

// P2, pass 2: out = bf16 of the max over the grid steps' slots.
__global__ void __launch_bounds__(THREADS)
probe_combine(const float* __restrict__ part, bf16* __restrict__ out, int steps,
              long long entries) {
  const long long i = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (i >= entries) return;
  float m = part[i];
  for (int s = 1; s < steps; ++s) m = fmaxf(m, part[s * entries + i]);
  out[i] = __float2bfloat16(m);
}


// ---------------------------------------------------------------------------
// P1 on the streaming path (stream_path below). It is bound by A's bytes,
// so the design is about keeping A's stream moving:
//   * Persistent blocks, as many as fit on the SMs, each walking the
//     160-row tiles blockIdx.x, + gridDim.x, ... The K slices of 64 of all its
//     tiles form one sequence that a ring of STAGES = 3 shared-memory stages
//     takes in, so the next tile's first slices are in flight while this tile
//     finishes and writes out. A is read once. (160 rows with 5 consumer
//     warps ran N = 128 faster than 128 rows with 4, and N = 48 as fast.)
//   * A's slices come by the Tensor Memory Accelerator: one thread asks for
//     each [160, 64] box of a tensor map over A, with zeros for rows past M
//     and k past K (K need only be a multiple of 8: 1296 = 20 x 64 + 16
//     leaves a ragged last slice). Copies of 16 bytes a thread (cp.async)
//     held A's stream to 2.3 TB/s with no products at all, under
//     torch.matmul's rate. The box lands with the 128-byte swizzle: the
//     16-byte unit u of row r at u ^ (r % 8), so the rows an ldmatrix reads
//     meet no bank conflict.
//   * Warp specialisation: a producer warp refills each stage as soon as the
//     5 consumer warps have released it (an mbarrier pair per stage: full,
//     counting the box's bytes; empty, counting the consumers), so no step
//     waits for the block's slowest warp before its slot is refilled.
//   * The producer warp streams B's slice from L2 beside A into each stage by
//     cp.async, counted on the same full barrier. A stage is then small
//     enough for two blocks on each SM (at N = 48), which ran faster than
//     keeping all of B in shared memory for the block's life (one block per
//     SM). B is staged as it lies: rows of B [K, N] feed mma through
//     ldmatrix.trans, rows of Bt [N, K] through ldmatrix, and nothing is
//     transposed by scatter. Its rows are padded to an odd number of 16-byte
//     units (padded()), which keeps its ldmatrix free of bank conflicts.
//   * The N tile is N rounded up to 16, so no product is spent past it. Each
//     consumer warp owns 32 rows (two m16 tiles) and the whole N tile, so
//     each B fragment feeds two products and each A fragment NT / 8.
//   * The epilogue rounds to bf16 into shared memory and writes 16-byte runs:
//     rows of N for [M, N], runs of 160 along M for [N, M] (elementwise where
//     M is not a multiple of 8 and those runs are not 16-byte aligned).
// ---------------------------------------------------------------------------
namespace stream {
constexpr int TM = 160, TK = 64, WARPS = 5, STAGES = 3;  // WARPS: the consumers
constexpr int CONSUMERS = 32 * WARPS, NTHREADS = CONSUMERS + 32;  // + the producer warp
constexpr int A_STAGE = TM * TK;  // elements of one TMA box: rows of 128 bytes
constexpr int LDBT = TK + 8;      // a staged Bt row
constexpr int LDT = TM + 8;       // a row of the [N, M] output tile
constexpr int MAX_N = 128;
constexpr int ALIGN = 1024;       // the swizzled boxes' alignment in shared memory
// the dynamic shared memory a block can use: 227 KB, less room for the
// kernel's static mbarriers
constexpr int SMEM_LIMIT = 232448 - 1024;

// a staged row of c elements, padded to an odd number of 16-byte units
__host__ __device__ constexpr int padded(int c) { return (c / 8) % 2 ? c : c + 8; }

struct Plan {
  int nt;       // N rounded up to 16
  int ldb;      // a staged row of B: along n for [K, N], along k for Bt
  int b_elems;  // B's slice in one stage
  int smem;
};

inline Plan plan(int N, bool b_kn) {
  Plan p;
  p.nt = (N + 15) / 16 * 16;
  p.ldb = b_kn ? padded(p.nt) : LDBT;
  p.b_elems = b_kn ? TK * p.ldb : p.nt * LDBT;
  const int epi = std::max(TM * padded(p.nt), p.nt * LDT);
  p.smem = ALIGN + (STAGES * (A_STAGE + p.b_elems) + epi) * 2;
  return p;
}
}  // namespace stream

template <int NT>
__global__ void __launch_bounds__(stream::NTHREADS)
gemm_stream(const __grid_constant__ CUtensorMap a_map, const bf16* __restrict__ b,
            bf16* __restrict__ out, int M, int N, int K, int b_kn, int o_mn, int ldb,
            int b_elems) {
  using namespace stream;
  using namespace mma_async;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  const void* a_tmap = &a_map;  // in the parameter space, where the TMA reads it
  const uint32_t base = smem_addr(smem_raw);
  bf16* ring = reinterpret_cast<bf16*>(smem_raw + (ALIGN - base % ALIGN) % ALIGN);
  bf16* b_s = ring + STAGES * A_STAGE;  // STAGES slices of B
  bf16* epi = b_s + STAGES * b_elems;   // the output tile
  constexpr int LDO = padded(NT);       // a row of the [M, N] output tile

  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int tiles = (M + TM - 1) / TM, slices = (K + TK - 1) / TK;
  const int k16 = (K + 15) / 16 * 16;
  const int total = (tiles - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x * slices;

  if (t == 0) {
    // full: the producer's arrival with the box's bytes, and each producer
    // lane's once its copies of B have landed
    for (int j = 0; j < STAGES; ++j) {
      mbar_init(&full[j], 33);
      mbar_init(&empty[j], WARPS);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == WARPS) {  // the producer
    for (int s = 0; s < total; ++s) {
      const int j = s % STAGES, n = s / STAGES;
      if (n > 0) mbar_wait(&empty[j], (n - 1) & 1);  // the consumers are done with stage j
      const int m0 = (blockIdx.x + (s / slices) * gridDim.x) * TM, kb = (s % slices) * TK;
      if (lane == 0) {
        mbar_expect_tx(&full[j], A_STAGE * 2);
        tma_load_2d(ring + j * A_STAGE, a_tmap, &full[j], kb, m0);
      }
      bf16* bs = b_s + j * b_elems;  // zero past N and past K
      if (b_kn) {  // rows k of B [K, N]
        for (int i = lane; i < TK * (NT / 8); i += 32) {
          const int r = i / (NT / 8), c = (i % (NT / 8)) * 8;
          const bool ok = kb + r < K && c < N;
          cp_async16(bs + r * ldb + c, ok ? b + static_cast<long long>(kb + r) * N + c : b, ok);
        }
      } else {  // rows n of Bt [N, K]
        for (int i = lane; i < NT * (TK / 8); i += 32) {
          const int r = i >> 3, c = (i & 7) * 8;
          const bool ok = r < N && kb + c < K;
          cp_async16(bs + r * ldb + c, ok ? b + static_cast<long long>(r) * K + kb + c : b, ok);
        }
      }
      cp_async_mbar_arrive(&full[j]);
    }
    cp_async_wait<0>();  // no copy outlives the block
    return;
  }

  // the consumers. A as staged: matrix mi holds rows 8 (mi & 1).. and k unit
  // mi >> 1 of a k16 step of an m16 tile, at its swizzled place. B: matrix mi
  // holds k 8 (mi & 1).. and n8 tile mi >> 1 of a pair (rows k for [K, N],
  // read through .trans; rows n for Bt).
  const int gq = lane >> 2, qd = lane & 3, mi = lane >> 3, mr = lane & 7;
  const int a_row = (32 * warp + mr + 8 * (mi & 1)) * TK;
  const int b_lane = b_kn ? (mr + 8 * (mi & 1)) * ldb + 8 * (mi >> 1)
                          : (mr + 8 * (mi >> 1)) * ldb + 8 * (mi & 1);
  const int b_kstep = b_kn ? 16 * ldb : 16, b_pair = b_kn ? 16 : 16 * ldb;

  float acc[2][NT / 8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int s = 0; s < total; ++s) {
    const int j = s % STAGES;
    mbar_wait(&full[j], (s / STAGES) & 1);  // step s's slices have landed
    const bf16* as = ring + j * A_STAGE;
    const int kb = (s % slices) * TK;
    const bf16* bs = b_s + j * b_elems;
    const int ksteps = min(TK, k16 - kb) / 16;
    for (int ks = 0; ks < ksteps; ++ks) {
      uint32_t af[2][4], bf[NT / 16][4];
      const int a_unit = ((2 * ks + (mi >> 1)) ^ mr) << 3;  // rows 8 apart share r % 8
      ldmatrix_x4(af[0], as + a_row + a_unit);
      ldmatrix_x4(af[1], as + a_row + 16 * TK + a_unit);
#pragma unroll
      for (int p = 0; p < NT / 16; ++p) {
        const bf16* bp = bs + b_lane + ks * b_kstep + p * b_pair;
        if (b_kn) ldmatrix_x4_trans(bf[p], bp);
        else ldmatrix_x4(bf[p], bp);
      }
#pragma unroll
      for (int p = 0; p < NT / 16; ++p)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma(acc[i][2 * p], af[i], bf[p][0], bf[p][1]);
          mma(acc[i][2 * p + 1], af[i], bf[p][2], bf[p][3]);
        }
    }
    fence_proxy_async();  // the reads of stage j before the TMA refills it (as K1's)
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[j]);  // this warp is done with stage j
    if (s % slices != slices - 1) continue;

    // the tile is done: bf16 into the output tile, then 16-byte runs out
    const int m0 = (blockIdx.x + (s / slices) * gridDim.x) * TM;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int jn = 0; jn < NT / 8; ++jn)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = 32 * warp + 16 * i + gq + 8 * h, c = 8 * jn + 2 * qd;
          const float lo = acc[i][jn][2 * h], hi = acc[i][jn][2 * h + 1];
          if (o_mn) {
            *reinterpret_cast<uint32_t*>(epi + r * LDO + c) = pack_bf16(lo, hi);
          } else {
            epi[c * LDT + r] = __float2bfloat16(lo);
            epi[(c + 1) * LDT + r] = __float2bfloat16(hi);
          }
          acc[i][jn][2 * h] = acc[i][jn][2 * h + 1] = 0.f;
        }
    bar_sync(1, CONSUMERS);  // the tile is in shared memory
    if (o_mn) {  // [M, N]: the tile's rows are one contiguous run
      const int rows = min(TM, M - m0), cn = N / 8;
      for (int i = t; i < rows * cn; i += CONSUMERS) {
        const int r = i / cn, c = (i - r * cn) * 8;
        *reinterpret_cast<uint4*>(out + static_cast<long long>(m0 + r) * N + c) =
            *reinterpret_cast<const uint4*>(epi + r * LDO + c);
      }
    } else {  // [N, M]: runs of 128 along M, one per row n
      const bool vec = M % 8 == 0;
      for (int i = t; i < N * (TM / 8); i += CONSUMERS) {
        const int n = i / (TM / 8), c = (i % (TM / 8)) * 8, m = m0 + c;
        bf16* dst = out + static_cast<long long>(n) * M + m;
        const bf16* src = epi + n * LDT + c;
        if (vec && m + 8 <= M) {
          *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
        } else {
          for (int e = 0; e < 8 && m + e < M; ++e) dst[e] = src[e];
        }
      }
    }
    bar_sync(1, CONSUMERS);  // ... and out of it, before the next tile's writes
  }
}

// A [M, K] bf16 as a tensor map of [160, 64] boxes with the 128-byte swizzle,
// zeros outside it. Returns 0, or a CUDA error code.
int a_tensor_map(CUtensorMap* map, const void* a, int M, int K) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(M)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(K) * 2};
  const cuuint32_t box[2] = {stream::TK, stream::TM};
  return mma_async::bf16_tensor_map(map, a, 2, dims, strides, box);
}

// The streaming path's shapes: K and N multiples of 8, N <= 128, B as [K, N]
// or Bt [N, K] and out as [M, N] or [N, M], each contiguous, every pointer
// 16-byte aligned. Every shape of tools/bench_gemm.py and chip_smoke.py.
bool stream_path(const void* a, const void* b, const void* out, long long b_ks, long long b_ns,
                 long long o_ms, long long o_ns, int M, int N, int K) {
  const bool b_layout = (b_ks == N && b_ns == 1) || (b_ks == 1 && b_ns == K);
  const bool o_layout = (o_ms == N && o_ns == 1) || (o_ms == 1 && o_ns == M);
  const bool aligned = (reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
                        reinterpret_cast<uintptr_t>(out)) % 16 == 0;
  return K % 8 == 0 && N % 8 == 0 && N <= stream::MAX_N && b_layout && o_layout && aligned;
}

template <int NT>
int launch_stream(const void* a, const void* b, void* out, int M, int N, int K, bool b_kn,
                  bool o_mn, const stream::Plan& p, cudaStream_t s) {
  static bool sized[mma_async::MAX_DEVICES] = {};  // above 48 KB once allowed, per device
  const int allowed = mma_async::allow_smem(
      reinterpret_cast<const void*>(gemm_stream<NT>), stream::SMEM_LIMIT, sized);
  if (allowed != 0) return allowed;
  CUtensorMap a_map;
  const int mapped = a_tensor_map(&a_map, a, M, K);
  if (mapped) return mapped;
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gemm_stream<NT>, stream::NTHREADS,
                                                        p.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (M + stream::TM - 1) / stream::TM;
  const int grid = std::min(tiles, sms * std::max(per_sm, 1));
  gemm_stream<NT><<<grid, stream::NTHREADS, p.smem, s>>>(
      a_map, static_cast<const bf16*>(b), static_cast<bf16*>(out), M, N, K, b_kn, o_mn, p.ldb,
      p.b_elems);
  return static_cast<int>(cudaGetLastError());
}

int launch_stream_any(const void* a, const void* b, void* out, long long b_ns, long long o_ms,
                      long long o_ns, int M, int N, int K, cudaStream_t s) {
  const bool b_kn = b_ns == 1, o_mn = o_ns == 1 && o_ms == N;
  const stream::Plan p = stream::plan(N, b_kn);
  switch (p.nt) {
    case 16: return launch_stream<16>(a, b, out, M, N, K, b_kn, o_mn, p, s);
    case 32: return launch_stream<32>(a, b, out, M, N, K, b_kn, o_mn, p, s);
    case 48: return launch_stream<48>(a, b, out, M, N, K, b_kn, o_mn, p, s);
    case 64: return launch_stream<64>(a, b, out, M, N, K, b_kn, o_mn, p, s);
    case 80: return launch_stream<80>(a, b, out, M, N, K, b_kn, o_mn, p, s);
    case 96: return launch_stream<96>(a, b, out, M, N, K, b_kn, o_mn, p, s);
    case 112: return launch_stream<112>(a, b, out, M, N, K, b_kn, o_mn, p, s);
    default: return launch_stream<128>(a, b, out, M, N, K, b_kn, o_mn, p, s);
  }
}

// ---------------------------------------------------------------------------
// P2 on the window path (window_path below; the design is in the note at the
// head of this file). A block is GROUPS consumer warpgroups and one producer
// warp.
// An item is one 64-row output tile of one grid step and one column tile; a
// block takes items blockIdx.x, + gridDim.x, ... For each item it runs the
// passes of window::pass_windows, each over the K slices of its slab.
// ---------------------------------------------------------------------------
namespace window {
constexpr int TM = 64, TK = 64;  // output rows of an item; k of a ring stage
constexpr int W = 8, GROUPS = 2, MAX_STAGES = 4;  // windows a pass; consumer warpgroups
constexpr int PER_GROUP = W / GROUPS;   // accumulators a warpgroup
constexpr int SLAB = TM + 8 * (W - 1);  // rows under W windows that slide by 8
constexpr int SLAB_BYTES = SLAB * TK * 2;
constexpr int ROW_BYTES = TK * 2;       // a staged row: 64 bf16, 128 bytes
constexpr int CONSUMERS = 128 * GROUPS, NTHREADS = CONSUMERS + 32;
constexpr int ALIGN = 1024;             // the swizzle atoms' alignment
constexpr int SMEM_LIMIT = 232448 - 1024;
static_assert(32 % W == 0 && W % GROUPS == 0, "a pass's windows stay in one round of 32");

// The passes of one item for R = reps products: a round of 32 products
// (windows 0..31) is split into passes of W consecutive windows; the last
// round takes the R mod 32 products left, its last pass fewer than W. So
// every product index 0..R-1 is taken once. (ops/gemm_probes.py
// pass_schedule is the same schedule in Python.)
__host__ __device__ inline int passes(int reps) {
  return reps / 32 * (32 / W) + (reps % 32 + W - 1) / W;
}

// pass p takes products 32 r + w0 .. 32 r + w0 + nw - 1: windows w0..w0 + nw - 1
__device__ __forceinline__ void pass_windows(int p, int reps, int& w0, int& nw) {
  const int r = p / (32 / W);
  w0 = (p % (32 / W)) * W;
  nw = min(W, reps - 32 * r - w0);
}

struct Plan {
  int nt;      // the N tile: 48, or 64 where N > 48 and B's [K, 64] fits beside 2 stages
  int stages;  // ring depth: MAX_STAGES, or what fits beside B
  int smem;
};

inline Plan plan(int K, int N) {
  const int slices = (K + TK - 1) / TK;
  Plan p;
  p.nt = N > 48 && ALIGN + slices * 64 * ROW_BYTES + 2 * SLAB_BYTES <= SMEM_LIMIT ? 64 : 48;
  const int b_bytes = slices * p.nt * ROW_BYTES;
  p.stages = std::min(MAX_STAGES, (SMEM_LIMIT - ALIGN - b_bytes) / SLAB_BYTES);
  p.smem = ALIGN + b_bytes + p.stages * SLAB_BYTES;
  return p;
}

// B's columns n0..n0 + NT - 1, transposed: slice sl holds rows n of 64 k
// (sl 64..), swizzled as the TMA would (16-byte unit u of row n at u ^ (n % 8));
// zeros past K and past N. Each thread writes 16-byte units, lanes along n.
template <int NT>
__device__ void stage_b(unsigned char* b_s, const bf16* __restrict__ b, int K, int N, int n0,
                        int slices, int t) {
  const unsigned short* bits = reinterpret_cast<const unsigned short*>(b);
  for (int i = t; i < slices * 8 * NT; i += CONSUMERS) {
    const int n = i % NT, u = (i / NT) % 8, sl = i / (8 * NT);
    const int k0 = sl * TK + 8 * u, col = n0 + n;
    uint32_t v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = k0 + 2 * e;
      const uint32_t lo = col < N && k < K ? bits[static_cast<long long>(k) * N + col] : 0;
      const uint32_t hi = col < N && k + 1 < K ? bits[static_cast<long long>(k + 1) * N + col] : 0;
      v[e] = lo | hi << 16;
    }
    *reinterpret_cast<uint4*>(b_s + sl * NT * ROW_BYTES + n * ROW_BYTES + ((u ^ (n & 7)) << 4)) =
        make_uint4(v[0], v[1], v[2], v[3]);
  }
}

// One slice of a pass: KS k16 steps of this warpgroup's NA windows (window
// group + GROUPS a of the slab for accumulator a), as one committed group.
// The first slice of a pass starts each sum afresh (accumulate = 0).
template <int NT, int NA, int KS>
__device__ __forceinline__ void issue(float (&acc)[PER_GROUP][NT / 2], uint32_t slab,
                                      uint32_t b_slice, int group, int accumulate) {
  mma_async::wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const uint64_t db = mma_async::sw128_desc(b_slice + 32 * ks);
#pragma unroll
    for (int a = 0; a < NA; ++a) {
      const uint32_t window = slab + (group + GROUPS * a) * 8 * ROW_BYTES;
      mma_async::wgmma_bf16<NT>(acc[a], mma_async::sw128_desc(window + 32 * ks), db,
                                ks > 0 || accumulate);
    }
  }
  mma_async::wgmma_commit();
}

// the k16 steps of a slice (4, or fewer in a last slice past K) as a template
// argument, so that each batch of wgmmas is straight-line code
template <int NT, int NA>
__device__ __forceinline__ void issue_slice(float (&acc)[PER_GROUP][NT / 2], uint32_t slab,
                                            uint32_t b_slice, int group, int accumulate,
                                            int ksteps) {
  switch (ksteps) {
    case 4: issue<NT, NA, 4>(acc, slab, b_slice, group, accumulate); break;
    case 3: issue<NT, NA, 3>(acc, slab, b_slice, group, accumulate); break;
    case 2: issue<NT, NA, 2>(acc, slab, b_slice, group, accumulate); break;
    default: issue<NT, NA, 1>(acc, slab, b_slice, group, accumulate); break;
  }
}

struct Ring {
  unsigned char* stages;
  uint64_t* full;
  uint64_t* empty;
  int depth;
};

// One pass of a consumer warpgroup with NA of its windows in the pass: over
// each slice, wait for the slab's slice, issue its products, and release the
// stage of the slice before once its products are done (one group stays in
// flight); then take the max of the NA sums into best. s counts the ring's
// steps.
template <int NT, int NA>
__device__ __forceinline__ void run_pass(float (&acc)[PER_GROUP][NT / 2], float (&best)[NT / 2],
                                         const Ring& ring, const unsigned char* b_s, int slices,
                                         int K, int group, int lane, int& s) {
  int held = -1;  // the stage whose products may still be running
  for (int sl = 0; sl < slices; ++sl, ++s) {
    const int j = s % ring.depth;
    mma_async::mbar_wait(&ring.full[j], (s / ring.depth) & 1);
    if constexpr (NA > 0) {
      issue_slice<NT, NA>(acc, mma_async::smem_addr(ring.stages + j * SLAB_BYTES),
                          mma_async::smem_addr(b_s + sl * NT * ROW_BYTES), group, sl > 0,
                          min(4, (K - sl * TK + 15) / 16));
      mma_async::wgmma_wait<1>();
      if (held >= 0 && lane == 0) mma_async::mbar_arrive(&ring.empty[held]);
      held = j;
    } else {
      __syncwarp();
      if (lane == 0) mma_async::mbar_arrive(&ring.empty[j]);
    }
  }
  if constexpr (NA > 0) {
    mma_async::wgmma_wait<0>();
    if (lane == 0) mma_async::mbar_arrive(&ring.empty[held]);
#pragma unroll
    for (int a = 0; a < NA; ++a)
#pragma unroll
      for (int e = 0; e < NT / 2; ++e) {
        mma_async::fence_operand(acc[a][e]);
        best[e] = fmaxf(best[e], acc[a][e]);
      }
  }
}

// run_pass with NA = mine, for mine in 0..PER_GROUP
template <int NT, int NA = PER_GROUP>
__device__ __forceinline__ void run_pass_for(int mine, float (&acc)[PER_GROUP][NT / 2],
                                             float (&best)[NT / 2], const Ring& ring,
                                             const unsigned char* b_s, int slices, int K,
                                             int group, int lane, int& s) {
  if constexpr (NA > 0) {
    if (mine < NA) {
      run_pass_for<NT, NA - 1>(mine, acc, best, ring, b_s, slices, K, group, lane, s);
      return;
    }
  }
  run_pass<NT, NA>(acc, best, ring, b_s, slices, K, group, lane, s);
}
}  // namespace window

// P2's window path: the max over R products of every item, floored at 0, into
// best [m_block, N] f32 (zeros before the launch) by atomicMax on the bits.
template <int NT>
__global__ void __launch_bounds__(window::NTHREADS, 1)
probe_windows(const __grid_constant__ CUtensorMap a_map, const bf16* __restrict__ b,
              float* __restrict__ best_out, int grid, int m_block, int K, int N, int reps,
              int depth) {
  using namespace window;
  using namespace mma_async;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[MAX_STAGES], empty[MAX_STAGES];
  const void* a_tmap = &a_map;  // in the parameter space, where the TMA reads it
  const uint32_t base = smem_addr(smem_raw);
  unsigned char* b_s = smem_raw + (ALIGN - base % ALIGN) % ALIGN;  // B's slices
  const int slices = (K + TK - 1) / TK;
  const Ring ring{b_s + slices * NT * ROW_BYTES, full, empty, depth};
  const int row_tiles = (m_block + TM - 1) / TM, col_tiles = (N + NT - 1) / NT;
  const int items = col_tiles * grid * row_tiles, npass = passes(reps);
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;

  if (t == 0) {
    for (int j = 0; j < depth; ++j) {
      mbar_init(&full[j], 1);                 // the producer's arrival with the bytes
      mbar_init(&empty[j], CONSUMERS / 32);   // each consumer warp's
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == CONSUMERS / 32) {  // the producer
    if (lane == 0) {
      int s = 0;
      for (int item = blockIdx.x; item < items; item += gridDim.x) {
        const int rt = item % row_tiles, step = item / row_tiles % grid;
        for (int p = 0; p < npass; ++p) {
          int w0, nw;
          pass_windows(p, reps, w0, nw);
          for (int sl = 0; sl < slices; ++sl, ++s) {
            const int j = s % depth, n = s / depth;
            if (n > 0) mbar_wait(&empty[j], (n - 1) & 1);  // the consumers are done with stage j
            mbar_expect_tx(&full[j], SLAB_BYTES);
            tma_load_3d(ring.stages + j * SLAB_BYTES, a_tmap, &full[j], sl * TK,
                        rt * TM + 8 * w0, step);
          }
        }
      }
    }
    return;
  }

  // the consumers
  const int group = warp / 4, wq = warp % 4;
  float acc[PER_GROUP][NT / 2];
  float best[NT / 2];
#pragma unroll
  for (int a = 0; a < PER_GROUP; ++a)
#pragma unroll
    for (int e = 0; e < NT / 2; ++e) acc[a][e] = 0.f;  // defined before the first wgmma reads them
  int staged = -1;  // the column tile whose B is in shared memory
  int s = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int rt = item % row_tiles, ct = item / (row_tiles * grid);
    if (ct != staged) {
      bar_sync(1, CONSUMERS);  // no product still reads the old columns
      stage_b<NT>(b_s, b, K, N, ct * NT, slices, t);
      fence_proxy_async();     // the stores, visible to wgmma (the async proxy)
      bar_sync(1, CONSUMERS);
      staged = ct;
    }
#pragma unroll
    for (int e = 0; e < NT / 2; ++e) best[e] = 0.f;  // the TPU kernel's zero-initialised max
    for (int p = 0; p < npass; ++p) {
      int w0, nw;
      pass_windows(p, reps, w0, nw);
      const int mine = nw > group ? (nw - group + GROUPS - 1) / GROUPS : 0;
      run_pass_for<NT>(mine, acc, best, ring, b_s, slices, K, group, lane, s);
    }
    // rows 16 wq + g (+ 8), columns 8 i + 2 q (+ 1) of the item's tile
    const int row0 = rt * TM + 16 * wq + (lane >> 2), col0 = ct * NT + 2 * (lane & 3);
#pragma unroll
    for (int e = 0; e < NT / 2; ++e) {
      const int row = row0 + 8 * ((e >> 1) & 1), col = col0 + 8 * (e >> 2) + (e & 1);
      if (best[e] > 0.f && row < m_block && col < N)
        atomicMax(reinterpret_cast<int*>(best_out) + static_cast<long long>(row) * N + col,
                  __float_as_int(best[e]));
    }
  }
}

// The window path's shapes: K a multiple of 8 (the TMA's row stride is 16-byte
// aligned). K <= 1600 and 16-byte aligned pointers hold for every call.
bool window_path(int K) { return K % 8 == 0; }

template <int NT>
int launch_windows(const void* a, const void* b, float* best, int grid, int m_block, int K,
                   int N, int reps, const window::Plan& p, cudaStream_t s) {
  using namespace window;
  static bool sized[mma_async::MAX_DEVICES] = {};  // above 48 KB once allowed, per device
  const int allowed = mma_async::allow_smem(
      reinterpret_cast<const void*>(probe_windows<NT>), SMEM_LIMIT, sized);
  if (allowed != 0) return allowed;
  // A as [grid][m_block + 256][K], boxes of 64 k x SLAB rows x 1 step, zeros past
  // K and past a step's rows
  CUtensorMap a_map;
  const long long rows = m_block + P2_PAD;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(grid)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(K) * 2,
                                 static_cast<cuuint64_t>(rows * K * 2)};
  const cuuint32_t box[3] = {TK, SLAB, 1};
  const int mapped = mma_async::bf16_tensor_map(&a_map, a, 3, dims, strides, box);
  if (mapped) return mapped;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(best, 0, static_cast<size_t>(m_block) * N * sizeof(float), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int items = (N + NT - 1) / NT * grid * ((m_block + TM - 1) / TM);
  probe_windows<NT><<<std::min(items, sms), NTHREADS, p.smem, s>>>(
      a_map, static_cast<const bf16*>(b), best, grid, m_block, K, N, reps, p.stages);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// P1: out = bf16(A B), A [M, K] bf16 contiguous and 16-byte aligned, B read
// as (k, n) at b + k b_ks + n b_ns, out written as (m, n) at out + m o_ms +
// n o_ns (elements). The kernel follows from the shapes: K and N multiples of
// 8 with N <= 128, B as [K, N] or Bt [N, K] and out as [M, N] or [N, M]
// (stream_path) take gemm_stream; every other shape takes gemm_p1. Returns
// cudaGetLastError() after the launch.
int gemm_probe_forward(const void* a, const void* b, long long b_ks, long long b_ns, void* out,
                       long long o_ms, long long o_ns, int M, int N, int K, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M < 1 || N < 1 || K < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (stream_path(a, b, out, b_ks, b_ns, o_ms, o_ns, M, N, K))
    return launch_stream_any(a, b, out, b_ns, o_ms, o_ns, M, N, K, s);
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  gemm_p1<<<grid, THREADS, 0, s>>>(static_cast<const bf16*>(a), static_cast<const bf16*>(b),
                                    b_ks, b_ns, static_cast<bf16*>(out), o_ms, o_ns, M, N, K);
  return static_cast<int>(cudaGetLastError());
}

// P2: out [m_block, N] bf16 from A [grid, m_block + 256, K] and B [K, N],
// bf16, contiguous and 16-byte aligned; part [grid, m_block, N] f32 is
// scratch. K <= 1600. The kernel follows from the shapes: K a multiple of 8
// (window_path) takes probe_windows, whose max lands in part's first
// [m_block, N]; other K take probe_partial, one slot of part per grid step.
// Then probe_combine rounds the max over the slots to bf16. Returns
// cudaGetLastError() after the launches.
int mma_probe_forward(const void* a, const void* b, void* part, void* out, int grid, int m_block,
                      int K, int N, int reps, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (grid < 1 || m_block < 1 || K < 1 || K > P2_MAX_K || N < 1 || reps < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long entries = static_cast<long long>(m_block) * N;
  const unsigned combine_blocks = static_cast<unsigned>((entries + THREADS - 1) / THREADS);
  if (window_path(K)) {
    const window::Plan p = window::plan(K, N);
    float* best = static_cast<float*>(part);
    const int launched =
        p.nt == 64 ? launch_windows<64>(a, b, best, grid, m_block, K, N, reps, p, s)
                   : launch_windows<48>(a, b, best, grid, m_block, K, N, reps, p, s);
    if (launched) return launched;
    probe_combine<<<combine_blocks, THREADS, 0, s>>>(best, static_cast<bf16*>(out), 1, entries);
    return static_cast<int>(cudaGetLastError());
  }
  const int ldb = (K + S::BK - 1) / S::BK * S::BK + 8;
  const int smem = (BM * S::LD + BN * ldb) * static_cast<int>(sizeof(bf16));
  static int allowed = 0;  // above 48 KB only once the kernel is allowed to
  if (smem > allowed) {
    const cudaError_t err =
        cudaFuncSetAttribute(probe_partial, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed = smem;
  }
  const dim3 blocks(grid, (m_block + BM - 1) / BM, (N + BN - 1) / BN);
  probe_partial<<<blocks, THREADS, smem, s>>>(static_cast<const bf16*>(a),
                                               static_cast<const bf16*>(b),
                                               static_cast<float*>(part), m_block, K, N, reps, ldb);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  probe_combine<<<combine_blocks, THREADS, 0, s>>>(static_cast<const float*>(part),
                                                   static_cast<bf16*>(out), grid, entries);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
