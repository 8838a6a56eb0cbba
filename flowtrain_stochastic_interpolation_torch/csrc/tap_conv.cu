// The tap-folded 3^3 convolution, written by hand for Hopper (sm_90a), with a
// plain C interface bound from Python through ctypes
// (flowtrain_stochastic_interpolation_torch/ops/tap_conv.py).
//
// K5a replaces flowtrain_stochastic_interpolation_tpu/ops/tap_conv.py
// _fwd_kernel (called from _tap_conv3d_fwd): a 3^3 stride-1 SAME convolution
// of channels-last x [B, X, Y, Z, Cin] with w [3, 3, 3, Cin, Cout] (DHWIO) as
// an implicit GEMM,
//     out[v, co] = x_dtype( f32 bias[co] + sum_k A[v, k] w[k, co] ),
//     A[v, (tap, c)] = x[neighbour of voxel v at tap, c]   (0 in the halo),
// products in x's dtype (bf16 or f32), accumulated in f32, one rounding at
// the end. K = 27 Cin folds all 27 taps (tap = 9 dx + 3 dy + dz, the order of
// DHWIO, so w is its own [27 Cin, Cout] matrix); the TPU kernel folds 9 (dy,
// dz) taps and runs 3 x-tap dots, which is the same sum in another order.
// With a flipped, channel-transposed w and no bias it is also the data
// gradient, so the kernel takes output widths up to 256 (the conv's Cin).
//
// K5b replaces _dw_kernel (called from _tap_conv3d_dw): the weight gradient
//     dw[(tap, c), co] = sum over voxels v of A[v, (tap, c)] g[v, co]
// in f32, a GEMM whose reduction axis is the B X Y Z voxels.
//
// Bound on the H100 at the flagship's train shape [8, 64^3, 48 -> 48], bf16:
// 2 x 2,097,152 x 1296 x 48 = 2.61e11 operations each, 0.264 ms at the
// 989 TFLOP/s of the bf16 tensor cores, against 0.40 GB of x and out (K5a)
// or x and g (K5b), 0.12 ms at 3.35 TB/s: both are bound by operations.
//
// What the design does about it (csrc/tile_mma.cuh): both are the block-tile
// GEMM of 128 x 64 with bf16 operands on the tensor cores (mma.sync
// m16n8k16) or f32 operands on the FP32 cores. The traps of the TPU kernel:
//   * The halo. The TPU kernel pads x into a copy first (221 MB at b8 64^3
//     48 bf16). Here nothing is padded: each staged element's neighbour is
//     checked against the volume and read as 0 outside it.
//   * The sequential grid. _dw_kernel accumulates dw across its grid, in
//     order. Here K5b is a partial pass, each block summing a chunk of voxels
//     for one 128 x 64 tile of dw into its own slot of f32 scratch, and a
//     combine pass that adds the chunks in a fixed order: no float atomics,
//     so dw is the same from run to run.
//   * Ragged K. Cin need not be a multiple of 8 (the 18-channel input conv:
//     K = 486): such a Cin stages its elements one by one, and the slice past
//     K is zero in both operands.
// The rest is first-version simple: A is re-read from L2 for each of the 27
// taps, every element's neighbour is tested on the fly, the output is
// written in 2-element pieces, and there is no load pipeline.

#include "tile_mma.cuh"

namespace {

using namespace tile;

__device__ __forceinline__ void coords(long long v, int X, int Y, int Z, int& x, int& y, int& z) {
  z = static_cast<int>(v % Z);
  const long long r = v / Z;
  y = static_cast<int>(r % Y);
  x = static_cast<int>((r / Y) % X);
}

// The flat index of the neighbour of voxel v = (x, y, z) at tap (9 dx + 3 dy
// + dz), or -1 where it lies in the halo.
__device__ __forceinline__ long long neighbour(long long v, int x, int y, int z, int tap, int X,
                                               int Y, int Z) {
  const int dx = tap / 9 - 1, dy = (tap / 3) % 3 - 1, dz = tap % 3 - 1;
  if (static_cast<unsigned>(x + dx) >= static_cast<unsigned>(X) ||
      static_cast<unsigned>(y + dy) >= static_cast<unsigned>(Y) ||
      static_cast<unsigned>(z + dz) >= static_cast<unsigned>(Z))
    return -1;
  return v + (static_cast<long long>(dx) * Y + dy) * Z + dz;
}

// A's run of 8 along k = (tap, c) for voxel v: x at the neighbour, 0 in the
// halo and past K. With Cin % 8 == 0 a run lies in one tap and is one load.
template <typename T>
__device__ __forceinline__ void conv_run(T (&r)[8], const T* x, long long v, int vx, int vy,
                                         int vz, int k, int cin, int X, int Y, int Z) {
  const int K = 27 * cin;
  if (cin % 8 == 0) {
    const long long nb = k < K ? neighbour(v, vx, vy, vz, k / cin, X, Y, Z) : -1;
    if (nb < 0) {
#pragma unroll
      for (int e = 0; e < 8; ++e) r[e] = zero_value<T>();
    } else {
      load_run(r, x + nb * cin + k % cin, 1, 8, true);
    }
    return;
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const long long nb = k + e < K ? neighbour(v, vx, vy, vz, (k + e) / cin, X, Y, Z) : -1;
    r[e] = nb < 0 ? zero_value<T>() : x[nb * cin + (k + e) % cin];
  }
}

// K5a: one block per 128 output voxels x 64 output channels.
template <typename T>
__global__ void __launch_bounds__(THREADS)
conv_forward(const T* __restrict__ x, const T* __restrict__ w, const float* __restrict__ bias,
             T* __restrict__ out, long long voxels, int X, int Y, int Z, int cin, int cout) {
  using S = Shape<T>;
  constexpr int ROWS_PER_PASS = THREADS / S::ROW_RUNS, PASSES = BM / ROWS_PER_PASS;
  __shared__ __align__(16) T a_s[BM * S::LD];
  __shared__ __align__(16) T b_s[BN * S::LD];
  const long long m0 = static_cast<long long>(blockIdx.x) * BM;
  const int n0 = blockIdx.y * BN;
  const int K = 27 * cin;
  const int t = threadIdx.x, k8 = (t % S::ROW_RUNS) * 8;

  // the output voxels whose rows of A this thread stages, and their coordinates
  long long vm[PASSES];
  int vx[PASSES], vy[PASSES], vz[PASSES];
#pragma unroll
  for (int p = 0; p < PASSES; ++p) {
    vm[p] = m0 + t / S::ROW_RUNS + p * ROWS_PER_PASS;
    coords(vm[p], X, Y, Z, vx[p], vy[p], vz[p]);
  }

  Acc acc;
  zero(acc);
  const WarpPos wp;
  for (int kb = 0; kb < K; kb += S::BK) {
    const int kn = min(S::BK, K - kb);
    __syncthreads();  // the previous slice is consumed
#pragma unroll
    for (int p = 0; p < PASSES; ++p) {
      alignas(16) T r[8];
      if (vm[p] < voxels) {
        conv_run(r, x, vm[p], vx[p], vy[p], vz[p], kb + k8, cin, X, Y, Z);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) r[e] = zero_value<T>();
      }
      store_row_run(a_s + (t / S::ROW_RUNS + p * ROWS_PER_PASS) * S::LD + k8, r);
    }
    // Bt[n][k] = w[k][n0 + n]: w is [27 Cin, Cout]
    stage<T, BN>(b_s, S::LD, w + static_cast<long long>(kb) * cout + n0, 1, cout, cout - n0, kn,
                 true);
    __syncthreads();
    warp_tile<T>(acc, a_s + wp.row0 * S::LD, S::LD, b_s + wp.col0 * S::LD, S::LD, kn);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const long long row = m0 + wp.row(i, e);
        const int col = n0 + wp.col(j, e);
        if (row < voxels && col < cout)
          out[row * cout + col] = from_float<T>(acc[i][j][e] + (bias ? bias[col] : 0.f));
      }
}

// K5b, pass 1: one block per (chunk of voxels, 128 rows (tap, c) of dw, 64
// output channels); its f32 sum goes to its own slot of part [chunks, 27
// Cin, Cout].
template <typename T>
__global__ void __launch_bounds__(THREADS)
conv_weight_partial(const T* __restrict__ x, const T* __restrict__ g, float* __restrict__ part,
                    long long voxels, int X, int Y, int Z, int cin, int cout, long long chunk) {
  using S = Shape<T>;
  constexpr int RUNS_PER_PASS = THREADS / S::BK, PASSES = (BM / 8) / RUNS_PER_PASS;
  __shared__ __align__(16) T a_s[BM * S::LD];
  __shared__ __align__(16) T b_s[BN * S::LD];
  const int rows = 27 * cin;
  const int r0 = blockIdx.y * BM, n0 = blockIdx.z * BN;
  const long long v0 = blockIdx.x * chunk, v1 = min(voxels, v0 + chunk);
  const int t = threadIdx.x, k = t % S::BK;  // this thread stages column k of A's slice

  Acc acc;
  zero(acc);
  const WarpPos wp;
  for (long long vb = v0; vb < v1; vb += S::BK) {
    const int kn = static_cast<int>(min(static_cast<long long>(S::BK), v1 - vb));
    __syncthreads();  // the previous slice is consumed
    // A[(tap, c)][k] = x at the neighbour of voxel vb + k: runs along the rows
    const long long v = vb + k;
    int vx, vy, vz;
    coords(v, X, Y, Z, vx, vy, vz);
#pragma unroll
    for (int p = 0; p < PASSES; ++p) {
      const int r8 = 8 * (t / S::BK + p * RUNS_PER_PASS);
      alignas(16) T r[8];
      if (k < kn && r0 + r8 < rows) {
        conv_run(r, x, v, vx, vy, vz, r0 + r8, cin, X, Y, Z);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) r[e] = zero_value<T>();
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) a_s[(r8 + e) * S::LD + k] = r[e];
    }
    // Bt[co][k] = g[vb + k][n0 + co]: g is [voxels, Cout]
    stage<T, BN>(b_s, S::LD, g + vb * cout + n0, 1, cout, cout - n0, kn, true);
    __syncthreads();
    warp_tile<T>(acc, a_s + wp.row0 * S::LD, S::LD, b_s + wp.col0 * S::LD, S::LD, kn);
  }

  float* slot = part + static_cast<long long>(blockIdx.x) * rows * cout;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = r0 + wp.row(i, e), col = n0 + wp.col(j, e);
        if (row < rows && col < cout) slot[static_cast<long long>(row) * cout + col] = acc[i][j][e];
      }
}

// K5b, pass 2: dw = the sum of the chunks' slots, in chunk order.
__global__ void __launch_bounds__(THREADS)
conv_weight_combine(const float* __restrict__ part, float* __restrict__ dw, long long entries,
                    int chunks) {
  const long long i = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (i >= entries) return;
  float s = 0.f;
  for (int c = 0; c < chunks; ++c) s += part[c * entries + i];
  dw[i] = s;
}

template <typename T>
int launch_forward(const void* x, const void* w, const void* bias, void* out, long long voxels,
                   int X, int Y, int Z, int cin, int cout, cudaStream_t s) {
  const dim3 grid(static_cast<unsigned>((voxels + BM - 1) / BM), (cout + BN - 1) / BN);
  conv_forward<T><<<grid, THREADS, 0, s>>>(static_cast<const T*>(x), static_cast<const T*>(w),
                                            static_cast<const float*>(bias), static_cast<T*>(out),
                                            voxels, X, Y, Z, cin, cout);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_weight_grad(const void* x, const void* g, void* part, void* dw, long long voxels, int X,
                       int Y, int Z, int cin, int cout, long long chunk, cudaStream_t s) {
  const int chunks = static_cast<int>((voxels + chunk - 1) / chunk);
  const dim3 grid(chunks, (27 * cin + BM - 1) / BM, (cout + BN - 1) / BN);
  conv_weight_partial<T><<<grid, THREADS, 0, s>>>(static_cast<const T*>(x),
                                                   static_cast<const T*>(g),
                                                   static_cast<float*>(part), voxels, X, Y, Z,
                                                   cin, cout, chunk);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long entries = 27LL * cin * cout;
  conv_weight_combine<<<static_cast<unsigned>((entries + THREADS - 1) / THREADS), THREADS, 0, s>>>(
      static_cast<const float*>(part), static_cast<float*>(dw), entries, chunks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// K5a: out [voxels, cout] (channels-last, in x's dtype) from x [voxels =
// B X Y Z, cin] and w [27 cin, cout] (DHWIO, already in x's dtype), both
// bf16 (is_f32 == 0) or both f32, contiguous and 16-byte aligned; bias [cout]
// f32 or NULL for none. 1 <= cout <= 256. Returns cudaGetLastError() after
// the launch, or cudaErrorInvalidValue for a cout or cin out of range.
int tap_conv_forward(const void* x, const void* w, const void* bias, void* out, int is_f32,
                     long long voxels, int X, int Y, int Z, int cin, int cout, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cin < 1 || cout < 1 || cout > 256) return static_cast<int>(cudaErrorInvalidValue);
  if (is_f32) return launch_forward<float>(x, w, bias, out, voxels, X, Y, Z, cin, cout, s);
  return launch_forward<__nv_bfloat16>(x, w, bias, out, voxels, X, Y, Z, cin, cout, s);
}

// K5b: dw [27 cin, cout] f32 from x [voxels, cin] and g [voxels, cout] (both
// bf16 or both f32, contiguous, 16-byte aligned). part [ceil(voxels / chunk),
// 27 cin, cout] f32 is scratch. Returns cudaGetLastError() after the two
// launches.
int tap_conv_weight_grad(const void* x, const void* g, void* part, void* dw, int is_f32,
                         long long voxels, int X, int Y, int Z, int cin, int cout,
                         long long chunk, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cin < 1 || cout < 1 || chunk < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (is_f32)
    return launch_weight_grad<float>(x, g, part, dw, voxels, X, Y, Z, cin, cout, chunk, s);
  return launch_weight_grad<__nv_bfloat16>(x, g, part, dw, voxels, X, Y, Z, cin, cout, chunk, s);
}

}  // extern "C"
