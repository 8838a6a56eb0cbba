// The GEMM probes behind the tap-folded conv, written by hand for Hopper
// (sm_90a), with a plain C interface bound from Python through ctypes
// (flowtrain_stochastic_interpolation_torch/ops/gemm_probes.py). Both are
// the block-tile GEMM of csrc/tile_mma.cuh (128 x 64 tiles, bf16 operands
// on the tensor cores through mma.sync.m16n8k16, f32 accumulation).
//
// P1 replaces tools/bench_pallas_gemm.py _mm_kernel / pallas_mm and
// _mm_kernel_t / pallas_mm_t: out = bf16(A B) for A [M, K] and B [K, N], in
// two output layouts, [M, N] and its transpose [N, M] (the TPU's "M on
// lanes" variant, which takes B transposed, Bt [N, K]). One kernel serves
// both through strides: B is read as (k, n) at b + k b_ks + n b_ns and out
// is written at out + m o_ms + n o_ns.
// Bound on the H100 at the probe's shape 524,288 x 1296 x 48: A is 1.36 GB,
// read once, against 6.5e10 operations: 0.42 ms at 3.35 TB/s and 0.07 ms at
// 989 TFLOP/s, so P1 is bound by bytes. The design reads each A tile once
// per 64 output columns (once in all at N = 48) with 16-byte loads; B (at
// most 330 KB) stays in L2.
//
// P2 replaces tools/bench_mxu_shapes.py _make_probe_kernel (called from
// _run): for A [grid, m_block + 256, K] and B [K, N],
//     out[m, n] = bf16( max(0, max over g < grid, i < R of
//                              A[g, 8 (i mod 32) + m, :] . B[:, n]) ),
// R products per grid step over row windows that slide by 8, max-accumulated
// so that no product can be folded into another. Every one of the R products
// is computed: a kernel that noticed that only 32 windows differ would void
// the probe. Its purpose is the tensor-core rate at each (K, N) with the
// operands kept on chip as far as a block can hold them. On the TPU the
// whole [m_block + 256, K] block of A sits in VMEM; here the block's [K, 64]
// columns of B stay in shared memory for all R products (173 KB at K =
// 1296, which caps K at 1600), but A does not fit: a 128-row window and its
// 248 rows of slide are 975 KB at K = 1296, against 227 KB of shared memory.
// So each product streams its A window through shared memory from L2 (the
// grid step's A is 6 MB at m_block 2048, K 1296; L2 holds 50 MB). The
// sequential grid of the TPU kernel, which max-accumulates into one output
// block, becomes a partial pass (one slot per grid step) and a combine pass.
// At (2048, 1296, 48, 16) with R = 256 the products are 1.04e12 operations,
// 1.06 ms at 989 TFLOP/s.

#include "tile_mma.cuh"

namespace {

using namespace tile;
using bf16 = __nv_bfloat16;
using S = Shape<bf16>;

constexpr int P2_PAD = 32 * 8;   // rows of slide below each grid step's m_block rows
constexpr int P2_MAX_K = 1600;   // the [K, 64] B tile must fit in shared memory

// P1: one block per 128 rows x 64 columns of A B.
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

}  // namespace

extern "C" {

// P1: out = bf16(A B), A [M, K] bf16 contiguous and 16-byte aligned, B read
// as (k, n) at b + k b_ks + n b_ns, out written as (m, n) at out + m o_ms +
// n o_ns (elements). Returns cudaGetLastError() after the launch.
int gemm_probe_forward(const void* a, const void* b, long long b_ks, long long b_ns, void* out,
                       long long o_ms, long long o_ns, int M, int N, int K, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M < 1 || N < 1 || K < 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  gemm_p1<<<grid, THREADS, 0, s>>>(static_cast<const bf16*>(a), static_cast<const bf16*>(b),
                                    b_ks, b_ns, static_cast<bf16*>(out), o_ms, o_ns, M, N, K);
  return static_cast<int>(cudaGetLastError());
}

// P2: out [m_block, N] bf16 from A [grid, m_block + 256, K] and B [K, N],
// bf16, contiguous and 16-byte aligned; part [grid, m_block, N] f32 is
// scratch. K <= 1600. Returns cudaGetLastError() after the two launches.
int mma_probe_forward(const void* a, const void* b, void* part, void* out, int grid, int m_block,
                      int K, int N, int reps, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (grid < 1 || m_block < 1 || K < 1 || K > P2_MAX_K || N < 1 || reps < 1)
    return static_cast<int>(cudaErrorInvalidValue);
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
  const long long entries = static_cast<long long>(m_block) * N;
  probe_combine<<<static_cast<unsigned>((entries + THREADS - 1) / THREADS), THREADS, 0, s>>>(
      static_cast<const float*>(part), static_cast<bf16*>(out), grid, entries);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
