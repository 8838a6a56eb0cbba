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
// What the design does about it. The flagship's shapes (bf16, Cin and Cout
// multiples of 8) take the box kernels on csrc/mma_async.cuh, further down:
// conv_forward_box for K5a (Cin <= 96, Cout <= 128) and conv_weight_box for
// K5b (both up to 128, not both past 96). Both stage boxes of x with their
// y-z halo by cp.async into shared-memory rings, once for all the taps that
// read them, and feed mma.sync m16n8k16 through ldmatrix with no transposing
// scatter. The traps of the TPU kernel:
//   * The halo. The TPU kernel pads x into a copy first (221 MB at b8 64^3
//     48 bf16). Here nothing is padded: each staged element's neighbour is
//     checked against the volume and read as 0 outside it.
//   * The sequential grid. _dw_kernel accumulates dw across its grid, in
//     order. Here K5b is a partial pass, each block summing its share of the
//     voxels for its part of dw into its own slot of f32 scratch, and a
//     combine pass that adds the slots in a fixed order: no float atomics,
//     so dw is the same from run to run.
//   * Ragged K. Cin need not be a multiple of 8 (the 18-channel input conv:
//     K = 486): such a Cin stages its elements one by one in the tile GEMM,
//     and the slice past K is zero in both operands.
// Every other shape (f32 operands, a ragged Cin or Cout, the wider widths)
// takes the block-tile GEMM of 128 x 64 of csrc/tile_mma.cuh: conv_forward
// for K5a, conv_weight_partial for K5b, with bf16 operands on the tensor
// cores or f32 operands on the FP32 cores. It is first-version simple: A is
// re-read from L2 for each of the 27 taps, every element's neighbour is
// tested on the fly, the output is written in 2-element pieces, and there is
// no load pipeline.

#include "mma_async.cuh"
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

// K5a, any shape: one block per 128 output voxels x 64 output channels.
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

// ---------------------------------------------------------------------------
// K5b on the box path: bf16, Cin and Cout multiples of 8 up to 128, except
// both past 96 (box_path below: the staged boxes and totals must fit).
//
// The GEMM dw[(tap, c), co] = sum_v A[(tap, c), v] g[v, co] runs with the
// voxels v as its k axis, 16 voxels (one z row of a box) per mma k-step. A
// block of the grid (slot, tap group) walks a run of boxes of BY x BZ = 8 x 16
// output voxels in one x plane of one batch item, and for each box stages,
// by cp.async into a ring of STAGES shared-memory buffers:
//   * x over the box's (BY + 2) x (BZ + 2) neighbourhood in the plane x + dx - 1
//     of its tap group's dx (every tap of a group shares dx), channels
//     contiguous as x lies in memory;
//   * g over the box itself;
// with zeros wherever the voxel lies outside the volume (the halo, a ragged
// box, a plane before the first or past the last). A box never leaves its
// batch item, so nothing of item b + 1 enters item b's sums.
//
// Every tap of the group reads the same staged x: the A fragment of (tap, 16
// channels) x 16 voxels is ldmatrix.trans from the staged rows of the voxels
// shifted by (dy, dz), one row address per lane; B is ldmatrix.trans from
// the staged g. Nothing is transposed on the way into shared memory, and the
// box coordinates advance by carries, not by division. Rows of both staged
// tiles are padded to an odd number of 16-byte units (padded()), so the eight
// consecutive voxels an ldmatrix reads fall in eight different bank groups.
//
// Work of a block: each warp owns one tap, one chunk of up to NW = 6 n8
// tiles of Cout and up to U = 3 tiles of 16 channels (72 f32 accumulators a
// thread); it loads g's fragments once per k-step for its U products. The tap
// group is the largest of 9 (one dx), 3 (one dx, dy) or 1 taps whose warps
// fit 9: at 48 -> 48 one dx, 9 warps, each one tap with its 3 channel tiles
// and the 6 n-tiles of Cout = 48 (no column wasted). Each block writes its
// taps' f32 partial dw to its own slot; the slots are just enough for the
// blocks of all tap groups to fill every SM once (box_slots), and
// conv_weight_combine sums them in slot order: no atomics, dw the
// same from run to run.
//
// The tensor cores' accumulators sum FLUSH = 4 boxes (512 voxels); then each
// thread adds them into its own running total in shared memory with f32 adds.
// A slot walks tens of thousands of voxels, and one accumulator over all of
// them drifts past 1e-4 of the plain version at the flagship's shape; a
// second set of 72 registers for the total would spill. -Xptxas -v:
// conv_weight_box<3> and <2> use 139 registers and spill nothing; one block
// of 9 warps per SM (the register file), 44 slots per tap group on 132 SMs.
// ---------------------------------------------------------------------------
namespace box {
constexpr int BY = 8, BZ = 16, HY = BY + 2, HZ = BZ + 2;  // the box, and its y-z neighbourhood
constexpr int U = 3, NW = 6, MAX_WARPS = 9, FLUSH = 4;
constexpr int TOTAL_BYTES = U * NW * 4 * 32 * 4;  // a warp's running totals
constexpr int MAX_CHANNELS = 128;
constexpr int SMEM_LIMIT = 232448;  // the dynamic shared memory a block can use

// a staged row of c channels, padded to an odd number of 16-byte units
__host__ __device__ constexpr int padded(int c) { return (c / 8) % 2 ? c : c + 8; }

struct Plan {
  int taps;     // taps per group: 9, 3 or 1
  int ctiles;   // 16-channel tiles of Cin
  int cgroups;  // groups of U channel tiles
  int nchunks;  // chunks of NW n8 tiles of Cout
  int warps, stages, smem;  // stages 0: the shapes do not fit shared memory
};

inline Plan plan(int cin, int cout) {
  Plan p;
  p.ctiles = (cin + 15) / 16;
  p.cgroups = (p.ctiles + U - 1) / U;
  p.nchunks = (cout / 8 + NW - 1) / NW;
  const int per_tap = p.cgroups * p.nchunks;  // at most 3 x 3 with Cin, Cout <= 128
  p.taps = 9 * per_tap <= MAX_WARPS ? 9 : 3 * per_tap <= MAX_WARPS ? 3 : 1;
  p.warps = p.taps * per_tap;
  const int stage = (HY * HZ * padded(cin) + BY * BZ * padded(cout)) * 2;
  const int totals = p.warps * TOTAL_BYTES;
  p.stages = 3 * stage + totals <= SMEM_LIMIT ? 3 : 2 * stage + totals <= SMEM_LIMIT ? 2 : 0;
  p.smem = p.stages * stage + totals;
  return p;
}
}  // namespace box

template <int STAGES>
__global__ void __launch_bounds__(32 * box::MAX_WARPS, 1)
conv_weight_box(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ g,
                float* __restrict__ part, int X, int Y, int Z, int cin, int cout, int taps,
                int ctiles, int cgroups, int nchunks, long long boxes, int slots) {
  using namespace box;
  using namespace mma_async;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int csx = padded(cin), csg = padded(cout);
  const int stage_elems = HY * HZ * csx + BY * BZ * csg;
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem_raw);

  const int t = threadIdx.x, nthreads = blockDim.x, warp = t >> 5, lane = t & 31;
  const int gq = lane >> 2, qd = lane & 3, mi = lane >> 3, mr = lane & 7;
  const int tap0 = blockIdx.y * taps, dx = tap0 / 9;

  // this warp's tap, chunk of n8 tiles and first channel tile
  const int cg = warp % cgroups, rest = warp / cgroups, nch = rest % nchunks;
  const int tap = tap0 + rest / nchunks, dy = (tap / 3) % 3, dz = tap % 3;
  const int ct0 = U * cg;
  const int ntc = min(NW, cout / 8 - NW * nch);  // n8 tiles in this warp's chunk
  // A^T as stored: rows are the voxels (k), columns the channels (m). Matrix
  // mi holds voxels 8 (mi >> 1).. of the k-step, shifted by (dy, dz), and
  // channels 8 (mi & 1).. of the tile; a tile's second half past Cin reads
  // the first (those rows are never stored).
  int a_off[U];
#pragma unroll
  for (int i = 0; i < U; ++i) {
    const int c0 = 16 * (ct0 + i);
    const int c = c0 + 8 * (mi & 1) < cin ? c0 + 8 * (mi & 1) : c0 < cin ? c0 : 0;
    a_off[i] = (dy * HZ + dz + mr + 8 * (mi >> 1)) * csx + c;
  }
  // B as stored: rows are the voxels, columns Cout. Matrix mi holds voxels
  // 8 (mi & 1).. and n8 tile 2p + (mi >> 1) of the chunk; a tile past Cout
  // reads column 0 and is never multiplied.
  const int b_row = (mr + 8 * (mi & 1)) * csg, b_col = 8 * (NW * nch + (mi >> 1));

  // staging: thread t copies 16-byte chunk t % (C / 8) of voxels t / (C / 8), + step
  const int chx = cin / 8, chg = cout / 8;
  const int stepx = nthreads / chx, stepg = nthreads / chg;
  const int c8x = t % chx, v0x = t < stepx * chx ? t / chx : HY * HZ;
  const int c8g = t % chg, v0g = t < stepg * chg ? t / chg : BY * BZ;

  // this slot's boxes, and the coordinates (item, plane, y box, z box) of the next to stage
  const int nyb = (Y + BY - 1) / BY, nzb = (Z + BZ - 1) / BZ;
  const long long first = boxes * blockIdx.x / slots, last = boxes * (blockIdx.x + 1) / slots;
  const int nbox = static_cast<int>(last - first);
  int zb, yb, xi, bi;
  {
    long long idx = first;
    zb = static_cast<int>(idx % nzb);
    idx /= nzb;
    yb = static_cast<int>(idx % nyb);
    idx /= nyb;
    xi = static_cast<int>(idx % X);
    bi = static_cast<int>(idx / X);
  }
  auto stage_next = [&](int buf) {
    __nv_bfloat16* xs = ring + buf * stage_elems;
    __nv_bfloat16* gs = xs + HY * HZ * csx;
    const int xp = xi + dx - 1;
    const bool plane = static_cast<unsigned>(xp) < static_cast<unsigned>(X);
    const long long plane_voxels = static_cast<long long>(Y) * Z;
    const __nv_bfloat16* xb = x + (static_cast<long long>(bi) * X + (plane ? xp : 0)) *
                                      plane_voxels * cin + 8 * c8x;
    const __nv_bfloat16* gb = g + (static_cast<long long>(bi) * X + xi) * plane_voxels * cout +
                              8 * c8g;
    const int y0 = yb * BY, z0 = zb * BZ;
    for (int rv = v0x; rv < HY * HZ; rv += stepx) {
      const int yr = rv / HZ, zr = rv - yr * HZ;
      const int y = y0 + yr - 1, z = z0 + zr - 1;
      const bool ok = plane && static_cast<unsigned>(y) < static_cast<unsigned>(Y) &&
                      static_cast<unsigned>(z) < static_cast<unsigned>(Z);
      cp_async16(xs + rv * csx + 8 * c8x, ok ? xb + (y * Z + z) * static_cast<long long>(cin) : x,
                 ok);
    }
    for (int rv = v0g; rv < BY * BZ; rv += stepg) {
      const int y = y0 + rv / BZ, z = z0 + rv % BZ;
      const bool ok = y < Y && z < Z;
      cp_async16(gs + rv * csg + 8 * c8g, ok ? gb + (y * Z + z) * static_cast<long long>(cout) : g,
                 ok);
    }
    // the next box: z box, then y box, then plane, then batch item
    if (++zb == nzb) {
      zb = 0;
      if (++yb == nyb) {
        yb = 0;
        if (++xi == X) {
          xi = 0;
          ++bi;
        }
      }
    }
  };

  // acc sums FLUSH boxes on the tensor cores; total[32 r] (this thread's
  // column of its warp's [72][32] block in shared memory) sums the flushes
  float acc[U][NW][4];
  float* total = reinterpret_cast<float*>(ring + STAGES * stage_elems) +
                 warp * (TOTAL_BYTES / 4) + lane;
#pragma unroll
  for (int i = 0; i < U; ++i)
#pragma unroll
    for (int j = 0; j < NW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[i][j][e] = 0.f;
        total[32 * ((i * NW + j) * 4 + e)] = 0.f;
      }

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nbox) stage_next(s);
    cp_async_commit();
  }
  for (int ib = 0; ib < nbox; ++ib) {
    cp_async_wait<STAGES - 2>();  // box ib has landed
    __syncthreads();              // ... for every thread, and box ib - 1 is consumed
    if (ib + STAGES - 1 < nbox) stage_next((ib + STAGES - 1) % STAGES);
    cp_async_commit();
    const __nv_bfloat16* xs = ring + (ib % STAGES) * stage_elems;
    const __nv_bfloat16* gs = xs + HY * HZ * csx;
#pragma unroll 2
    for (int j = 0; j < BY; ++j) {  // k-step: the 16 voxels of the box's row j
      uint32_t bf[NW / 2][4];
#pragma unroll
      for (int p = 0; p < NW / 2; ++p) {
        const int col = b_col + 16 * p;
        if (2 * p < ntc) ldmatrix_x4_trans(bf[p], gs + j * BZ * csg + b_row + (col < cout ? col : 0));
      }
#pragma unroll
      for (int i = 0; i < U; ++i) {
        if (ct0 + i >= ctiles) break;
        uint32_t af[4];
        ldmatrix_x4_trans(af, xs + j * HZ * csx + a_off[i]);
#pragma unroll
        for (int nt = 0; nt < NW; ++nt)
          if (nt < ntc) mma(acc[i][nt], af, bf[nt / 2][2 * (nt & 1)], bf[nt / 2][2 * (nt & 1) + 1]);
      }
    }
    if ((ib + 1) % FLUSH == 0 || ib + 1 == nbox) {
#pragma unroll
      for (int i = 0; i < U; ++i)
#pragma unroll
        for (int j = 0; j < NW; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            total[32 * ((i * NW + j) * 4 + e)] += acc[i][j][e];
            acc[i][j][e] = 0.f;
          }
    }
  }
  cp_async_wait<0>();  // no copy outlives the block

  float* slot = part + static_cast<long long>(blockIdx.x) * 27 * cin * cout;
#pragma unroll
  for (int i = 0; i < U; ++i) {
#pragma unroll
    for (int nt = 0; nt < NW; ++nt) {
      if (nt >= ntc) break;
      const int col = 8 * (NW * nch + nt) + 2 * qd;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = 16 * (ct0 + i) + gq + 8 * h;
        if (c < cin)
          *reinterpret_cast<float2*>(slot + (static_cast<long long>(tap) * cin + c) * cout + col) =
              make_float2(total[32 * ((i * NW + nt) * 4 + 2 * h)],
                          total[32 * ((i * NW + nt) * 4 + 2 * h + 1)]);
      }
    }
  }
}

// The box path's shapes: bf16, Cin and Cout multiples of 8 up to 128 whose
// staged boxes and totals fit shared memory (all but Cin and Cout both past 96).
bool box_path(int is_f32, int cin, int cout) {
  return !is_f32 && cin % 8 == 0 && cout % 8 == 0 && cin <= box::MAX_CHANNELS &&
         cout <= box::MAX_CHANNELS && box::plan(cin, cout).stages > 0;
}

// The box kernel's slots: enough blocks of every tap group to fill each SM
// with as many blocks as fit (at least one), and no more than there are boxes.
template <int STAGES>
int box_slots(const box::Plan& p, long long boxes, int* slots) {
  static bool sized[mma_async::MAX_DEVICES] = {};  // above 48 KB once allowed, per device
  const int allowed = mma_async::allow_smem(
      reinterpret_cast<const void*>(conv_weight_box<STAGES>), box::SMEM_LIMIT, sized);
  if (allowed != 0) return allowed;
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, conv_weight_box<STAGES>,
                                                        32 * p.warps, p.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int groups = 27 / p.taps;
  const long long want = (static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1) + groups - 1) / groups;
  *slots = static_cast<int>(want < boxes ? want : boxes);
  if (*slots < 1) *slots = 1;
  return 0;
}

long long box_count(long long voxels, int X, int Y, int Z) {
  const long long batch = voxels / (static_cast<long long>(X) * Y * Z);
  return batch * X * ((Y + box::BY - 1) / box::BY) * ((Z + box::BZ - 1) / box::BZ);
}

template <int STAGES>
int launch_weight_box(const void* x, const void* g, void* part, void* dw, long long voxels, int X,
                      int Y, int Z, int cin, int cout, const box::Plan& p, cudaStream_t s) {
  const long long boxes = box_count(voxels, X, Y, Z);
  int slots = 0;
  const int err = box_slots<STAGES>(p, boxes, &slots);
  if (err) return err;
  const dim3 grid(slots, 27 / p.taps);
  conv_weight_box<STAGES><<<grid, 32 * p.warps, p.smem, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(g),
      static_cast<float*>(part), X, Y, Z, cin, cout, p.taps, p.ctiles, p.cgroups, p.nchunks, boxes,
      slots);
  const cudaError_t launched = cudaGetLastError();
  if (launched != cudaSuccess) return static_cast<int>(launched);
  const long long entries = 27LL * cin * cout;
  conv_weight_combine<<<static_cast<unsigned>((entries + THREADS - 1) / THREADS), THREADS, 0, s>>>(
      static_cast<const float*>(part), static_cast<float*>(dw), entries, slots);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// K5a on the box path: bf16, Cin and Cout multiples of 8, Cin <= 96 and
// Cout <= 128 (forward_box_path below).
//
// The implicit GEMM out[v, co] = sum_k A[v, k] w[k, co] runs with the voxels
// v as its m axis, in boxes of BY x BZ = 8 x 16 output voxels, one z row of a
// box per m16 tile. A block owns a column of boxes (one y box and z box of one
// batch item) over a run of x planes, and walks it plane by plane:
//   * A ring of 3 shared-memory slots holds the (BY + 2) x (BZ + 2)
//     neighbourhoods of planes xi - 1, xi and xi + 1, filled by cp.async
//     with zeros outside the volume: the y-z halo, the faces, and the planes
//     before 0 and past X - 1. Once the 9 taps of dx = 0 are done, the slot
//     of plane xi - 1 takes plane xi + 2 while the other 18 taps run. So each
//     plane is fetched once per box column, (10 x 18) / (8 x 16) = 1.4 times
//     the bytes of x, where the tile kernel passes x through L2 27 times.
//     A block never leaves its batch item.
//   * A fragments (voxels x channels) come through ldmatrix from the staged
//     rows of the voxels shifted by (dy, dz), one row address per lane, so a
//     tap's shift costs nothing. B fragments come from w [27 Cin, Cout]
//     through ldmatrix.trans.
//   * w stays in shared memory for the block's life where it fits beside the
//     ring (48 -> 48: 145 KB beside 60 KB; faster there than streaming it);
//     else each tap's [Cin, Cout] comes through a second ring of WS = 3 slots
//     from L2 (96 -> 96: 20 KB a tap).
//   * 8 warps: 4 along the box's y rows (MT = 2 m16 tiles each) x 2 chunks of
//     Cout's n8 tiles (3 each at Cout = 48: no column wasted). Each B
//     fragment feeds two products, each A fragment its chunk's n8 tiles. At
//     48 -> 48 this ran faster than 16 warps of one tile or 4 warps of four
//     (tools/ab_gemm_conv.py).
//   * The output leaves the registers as bf16 pairs, the f32 bias added
//     before the one rounding.
// A Cin that is an odd multiple of 8 (8, 24, ...) ends each tap with a half
// k16 step: its second half reads the first and is zeroed in A.
// The x walk of a box column is split in segments where that evens out the
// waves of blocks on the SMs (forward_segments): at 16^3 or 32^3 a box
// column alone leaves most SMs idle.
// ---------------------------------------------------------------------------
namespace fwd {
constexpr int BY = 8, BZ = 16, HY = BY + 2, HZ = BZ + 2, ROWS = HY * HZ;
constexpr int MT = 2;  // m16 tiles (y rows of the box) a warp
constexpr int WARPS_M = BY / MT, SLOTS = 3, WS = 3;
constexpr int MAX_THREADS = 32 * WARPS_M * 2;
constexpr int MAX_CIN = 96, MAX_COUT = 128;

struct Plan {
  int nchunks;   // chunks of Cout's n8 tiles: 2, or 1 at Cout = 8
  int nw;        // n8 tiles per chunk
  int warps;
  int resident;  // all of w stays in shared memory
  int smem;
};

inline Plan plan(int cin, int cout) {
  Plan p;
  const int ntiles = cout / 8;
  p.nchunks = ntiles >= 2 ? 2 : 1;
  p.nw = (ntiles + p.nchunks - 1) / p.nchunks;
  p.warps = WARPS_M * p.nchunks;
  const int planes = SLOTS * ROWS * box::padded(cin);
  const int w_all = 27 * cin * box::padded(cout);
  p.resident = (w_all + planes) * 2 <= box::SMEM_LIMIT;
  p.smem = ((p.resident ? w_all : WS * cin * box::padded(cout)) + planes) * 2;
  return p;
}
}  // namespace fwd

template <int NW>
__global__ void __launch_bounds__(fwd::MAX_THREADS, 1)
conv_forward_box(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                 const float* __restrict__ bias, __nv_bfloat16* __restrict__ out, int X, int Y,
                 int Z, int cin, int cout, int segments, int resident) {
  using namespace fwd;
  using namespace mma_async;
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int csx = box::padded(cin), ldw = box::padded(cout);
  const int plane_elems = ROWS * csx, tap_elems = cin * ldw;
  bf16* w_s = reinterpret_cast<bf16*>(smem_raw);  // all of w, or a ring of WS taps
  bf16* planes = w_s + (resident ? 27 : WS) * tap_elems;

  const int t = threadIdx.x, nthreads = blockDim.x, warp = t >> 5, lane = t & 31;
  const int gq = lane >> 2, qd = lane & 3, mi = lane >> 3, mr = lane & 7;
  const int wm = warp % WARPS_M, nch = warp / WARPS_M;
  const int ntc = min(NW, cout / 8 - NW * nch);  // n8 tiles in this warp's chunk

  // the block's box column and x segment
  const int nzb = (Z + BZ - 1) / BZ, nyb = (Y + BY - 1) / BY;
  int idx = blockIdx.x;
  const int zb = idx % nzb;
  idx /= nzb;
  const int yb = idx % nyb;
  idx /= nyb;
  const int seg = idx % segments, bi = idx / segments;
  const int x_begin = seg * X / segments, x_end = (seg + 1) * X / segments;
  const int y0 = yb * BY, z0 = zb * BZ;
  const long long plane_voxels = static_cast<long long>(Y) * Z;
  const bf16* x_item = x + static_cast<long long>(bi) * X * plane_voxels * cin;

  // x plane xp (-1 <= xp <= X) over the box's neighbourhood, into its slot
  auto stage_plane = [&](int xp) {
    bf16* ps = planes + ((xp + SLOTS) % SLOTS) * plane_elems;
    const bool plane = 0 <= xp && xp < X;
    const int cn = cin / 8;
    for (int i = t; i < ROWS * cn; i += nthreads) {
      const int rv = i / cn, c = (i - rv * cn) * 8;
      const int yr = rv / HZ, zr = rv - yr * HZ;
      const int y = y0 + yr - 1, z = z0 + zr - 1;
      const bool ok = plane && static_cast<unsigned>(y) < static_cast<unsigned>(Y) &&
                      static_cast<unsigned>(z) < static_cast<unsigned>(Z);
      cp_async16(ps + rv * csx + c,
                 ok ? x_item + (xp * plane_voxels + static_cast<long long>(y) * Z + z) * cin + c
                    : x,
                 ok);
    }
  };
  // rows row0 .. row0 + rows - 1 of w [27 Cin, Cout] into dst
  auto stage_w = [&](bf16* dst, int row0, int rows) {
    const int cn = cout / 8;
    for (int i = t; i < rows * cn; i += nthreads) {
      const int r = i / cn, c = (i - r * cn) * 8;
      cp_async16(dst + r * ldw + c, w + static_cast<long long>(row0 + r) * cout + c, true);
    }
  };

  // A as staged: rows are the neighbourhood's voxels, columns the channels.
  // Matrix mi holds z 8 (mi & 1).. of the warp's y row (m16 tile i) and
  // channels 8 (mi >> 1).. of the k16 step. B as staged: rows are a tap's
  // channels, columns Cout; matrix mi holds channels 8 (mi & 1).. and n8
  // tile mi >> 1 of a pair. In a half step the second half reads the first.
  int a_off[MT];
#pragma unroll
  for (int i = 0; i < MT; ++i)
    a_off[i] = ((MT * wm + i) * HZ + mr + 8 * (mi & 1)) * csx + 8 * (mi >> 1);
  const int a_half = 8 * (mi >> 1);
  const int b_off = (mr + 8 * (mi & 1)) * ldw + 8 * (NW * nch + (mi >> 1));
  const int b_half = 8 * (mi & 1) * ldw;
  const int csteps = (cin + 15) / 16;
  const bool half_last = cin % 16 != 0;

  float acc[MT][NW][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // the first group: w (all of it, or tap 0) and planes x_begin - 1 .. x_begin + 1
  const int total = (x_end - x_begin) * 27;
  stage_w(w_s, 0, resident ? 27 * cin : cin);
  for (int d = -1; d <= 1; ++d) stage_plane(x_begin + d);
  cp_async_commit();
  if (!resident) {
#pragma unroll
    for (int s = 1; s < WS - 1; ++s) {
      if (s < total) stage_w(w_s + s * tap_elems, (s % 27) * cin, cin);
      cp_async_commit();
    }
  }

  for (int s = 0; s < total; ++s) {
    const int pl = s / 27, tap = s - 27 * pl, xi = x_begin + pl;
    if (!resident) {  // a w tap per step, and plane xi + 2 with tap 9
      cp_async_wait<WS - 2>();  // step s's tap has landed
      __syncthreads();          // ... for every thread, and step s - 1 is consumed
      const int sn = s + WS - 1;
      if (sn < total) stage_w(w_s + (sn % WS) * tap_elems, (sn % 27) * cin, cin);
      if (tap == 9 && xi + 1 < x_end) stage_plane(xi + 2);
      cp_async_commit();
    } else if (tap == 0) {
      cp_async_wait<0>();  // plane xi + 1 has landed
      __syncthreads();
    } else if (tap == 9) {
      __syncthreads();  // the taps of dx = 0 are done with plane xi - 1
      if (xi + 1 < x_end) stage_plane(xi + 2);
      cp_async_commit();
    }
    const int dx = tap / 9, dy = (tap / 3) % 3, dz = tap % 3;
    const bf16* xs = planes + ((xi + dx - 1 + SLOTS) % SLOTS) * plane_elems + (dy * HZ + dz) * csx;
    const bf16* wt = w_s + (resident ? tap : s % WS) * tap_elems;
    for (int cs = 0; cs < csteps; ++cs) {
      const bool half = half_last && cs == csteps - 1;
      uint32_t af[MT][4], bf[(NW + 1) / 2][4];
#pragma unroll
      for (int i = 0; i < MT; ++i)
        ldmatrix_x4(af[i], xs + a_off[i] + 16 * cs - (half ? a_half : 0));
      const bf16* wk = wt + 16 * cs * ldw + b_off - (half ? b_half : 0);
#pragma unroll
      for (int p = 0; p < (NW + 1) / 2; ++p) {
        if (2 * p + 1 < ntc) {
          ldmatrix_x4_trans(bf[p], wk + 16 * p);
        } else if (2 * p < ntc) {
          uint32_t b2[2];
          ldmatrix_x2_trans(b2, wk + 16 * p);
          bf[p][0] = b2[0];
          bf[p][1] = b2[1];
        }
      }
      if (half) {
#pragma unroll
        for (int i = 0; i < MT; ++i) af[i][2] = af[i][3] = 0u;
      }
#pragma unroll
      for (int p = 0; p < (NW + 1) / 2; ++p)
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          if (2 * p < ntc) mma(acc[i][2 * p], af[i], bf[p][0], bf[p][1]);
          if (2 * p + 1 < ntc) mma(acc[i][2 * p + 1], af[i], bf[p][2], bf[p][3]);
        }
    }
    if (tap != 26) continue;

    // plane xi is done: + bias, one rounding, bf16 pairs out
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int y = y0 + MT * wm + i;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int z = z0 + gq + 8 * h;
        bf16* o = out + ((static_cast<long long>(bi) * X + xi) * plane_voxels +
                         static_cast<long long>(y) * Z + z) * cout;
#pragma unroll
        for (int nt = 0; nt < NW; ++nt) {
          const int co = 8 * (NW * nch + nt) + 2 * qd;
          if (nt < ntc && y < Y && z < Z)
            *reinterpret_cast<uint32_t*>(o + co) =
                pack_bf16(acc[i][nt][2 * h] + (bias ? bias[co] : 0.f),
                          acc[i][nt][2 * h + 1] + (bias ? bias[co + 1] : 0.f));
          acc[i][nt][2 * h] = acc[i][nt][2 * h + 1] = 0.f;
        }
      }
    }
  }
  cp_async_wait<0>();  // no copy outlives the block
}

// The forward box path's shapes: bf16, Cin and Cout multiples of 8, Cin <= 96
// and Cout <= 128 (the ring and w, or w's ring, fit shared memory at all of them).
bool forward_box_path(int is_f32, int cin, int cout) {
  return !is_f32 && cin % 8 == 0 && cout % 8 == 0 && cin <= fwd::MAX_CIN &&
         cout <= fwd::MAX_COUT && fwd::plan(cin, cout).smem <= box::SMEM_LIMIT;
}

// Segments of the x walk: the count s (at most X) that minimises the waves of
// blocks on the card times the planes a block walks, each segment's first
// plane counted one and a half times (the two planes of halo it stages first).
int forward_segments(long long columns, int X, long long concurrent) {
  int best = 1;
  long long best_cost = -1;
  for (int s = 1; s <= X && s <= 64; ++s) {
    const long long waves = (columns * s + concurrent - 1) / concurrent;
    const long long cost = waves * (2LL * ((X + s - 1) / s) + 1);
    if (best_cost < 0 || cost < best_cost) {
      best = s;
      best_cost = cost;
    }
  }
  return best;
}

template <int NW>
int launch_forward_box(const void* x, const void* w, const void* bias, void* out, long long voxels,
                       int X, int Y, int Z, int cin, int cout, const fwd::Plan& p,
                       cudaStream_t s) {
  static bool sized[mma_async::MAX_DEVICES] = {};  // above 48 KB once allowed, per device
  const int allowed = mma_async::allow_smem(
      reinterpret_cast<const void*>(conv_forward_box<NW>), box::SMEM_LIMIT, sized);
  if (allowed != 0) return allowed;
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, conv_forward_box<NW>,
                                                        32 * p.warps, p.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long batch = voxels / (static_cast<long long>(X) * Y * Z);
  const long long columns =
      batch * ((Y + fwd::BY - 1) / fwd::BY) * ((Z + fwd::BZ - 1) / fwd::BZ);
  const int segments =
      forward_segments(columns, X, static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1));
  conv_forward_box<NW><<<static_cast<unsigned>(columns * segments), 32 * p.warps, p.smem, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(out), X, Y, Z, cin, cout,
      segments, p.resident);
  return static_cast<int>(cudaGetLastError());
}

int launch_forward_box_any(const void* x, const void* w, const void* bias, void* out,
                           long long voxels, int X, int Y, int Z, int cin, int cout,
                           cudaStream_t s) {
  const fwd::Plan p = fwd::plan(cin, cout);
  switch (p.nw) {
    case 1: return launch_forward_box<1>(x, w, bias, out, voxels, X, Y, Z, cin, cout, p, s);
    case 2: return launch_forward_box<2>(x, w, bias, out, voxels, X, Y, Z, cin, cout, p, s);
    case 3: return launch_forward_box<3>(x, w, bias, out, voxels, X, Y, Z, cin, cout, p, s);
    case 4: return launch_forward_box<4>(x, w, bias, out, voxels, X, Y, Z, cin, cout, p, s);
    case 5: return launch_forward_box<5>(x, w, bias, out, voxels, X, Y, Z, cin, cout, p, s);
    case 6: return launch_forward_box<6>(x, w, bias, out, voxels, X, Y, Z, cin, cout, p, s);
    case 7: return launch_forward_box<7>(x, w, bias, out, voxels, X, Y, Z, cin, cout, p, s);
    default: return launch_forward_box<8>(x, w, bias, out, voxels, X, Y, Z, cin, cout, p, s);
  }
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
// f32 or NULL for none. 1 <= cout <= 256. The kernel follows from the shapes:
// bf16 with Cin and Cout multiples of 8, Cin <= 96 and Cout <= 128
// (forward_box_path: the flagship's 48 -> 48 and its data gradient, 96 ->
// 48, 96 -> 96) takes conv_forward_box; f32, a ragged Cin or Cout (the
// 18-channel input conv and its data gradient 48 -> 18) and the wider ones
// take conv_forward. Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a cout or cin out of range.
int tap_conv_forward(const void* x, const void* w, const void* bias, void* out, int is_f32,
                     long long voxels, int X, int Y, int Z, int cin, int cout, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cin < 1 || cout < 1 || cout > 256) return static_cast<int>(cudaErrorInvalidValue);
  if (forward_box_path(is_f32, cin, cout))
    return launch_forward_box_any(x, w, bias, out, voxels, X, Y, Z, cin, cout, s);
  if (is_f32) return launch_forward<float>(x, w, bias, out, voxels, X, Y, Z, cin, cout, s);
  return launch_forward<__nv_bfloat16>(x, w, bias, out, voxels, X, Y, Z, cin, cout, s);
}

// K5b: the number of f32 slots of [27 cin, cout] that tap_conv_weight_grad
// needs as scratch for these shapes (given the same chunk), or -1 with a CUDA
// error code in *err. The box path (box_path above) takes a small multiple of
// the SM count; the others one slot per chunk of voxels.
long long tap_conv_weight_grad_slots(int is_f32, long long voxels, int X, int Y, int Z, int cin,
                                     int cout, long long chunk, int* err) {
  *err = 0;
  if (cin < 1 || cout < 1 || chunk < 1) {
    *err = static_cast<int>(cudaErrorInvalidValue);
    return -1;
  }
  if (!box_path(is_f32, cin, cout)) return (voxels + chunk - 1) / chunk;
  const box::Plan p = box::plan(cin, cout);
  int slots = 0;
  *err = p.stages == 3 ? box_slots<3>(p, box_count(voxels, X, Y, Z), &slots)
                       : box_slots<2>(p, box_count(voxels, X, Y, Z), &slots);
  return *err ? -1 : slots;
}

// K5b: dw [27 cin, cout] f32 from x [voxels, cin] and g [voxels, cout] (both
// bf16 or both f32, contiguous, 16-byte aligned). part [slots, 27 cin, cout]
// f32 is scratch, with slots from tap_conv_weight_grad_slots. bf16 with Cin
// and Cout multiples of 8 up to 128 takes the box kernel; every other shape
// (f32, a ragged or wider Cin) takes conv_weight_partial. Returns
// cudaGetLastError() after the two launches.
int tap_conv_weight_grad(const void* x, const void* g, void* part, void* dw, int is_f32,
                         long long voxels, int X, int Y, int Z, int cin, int cout,
                         long long chunk, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cin < 1 || cout < 1 || chunk < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (box_path(is_f32, cin, cout)) {
    const box::Plan p = box::plan(cin, cout);
    if (p.stages == 3)
      return launch_weight_box<3>(x, g, part, dw, voxels, X, Y, Z, cin, cout, p, s);
    return launch_weight_box<2>(x, g, part, dw, voxels, X, Y, Z, cin, cout, p, s);
  }
  if (is_f32)
    return launch_weight_grad<float>(x, g, part, dw, voxels, X, Y, Z, cin, cout, chunk, s);
  return launch_weight_grad<__nv_bfloat16>(x, g, part, dw, voxels, X, Y, Z, cin, cout, chunk, s);
}

}  // extern "C"
