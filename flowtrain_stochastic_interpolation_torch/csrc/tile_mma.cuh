// One block-tile GEMM design for the shapes that the redesigned kernels of
// csrc/mma_async.cuh do not take: the tap-folded conv's f32 and ragged
// shapes (conv_forward for K5a, conv_weight_partial for K5b, csrc/tap_conv.cu)
// and the GEMM probes' (gemm_p1 for P1's other shapes, and P2,
// csrc/gemm_probes.cu).
//
// A block of 256 threads (8 warps, 4 along M x 2 along N) owns a BM x BN =
// 128 x 64 tile of C = A B. The reduction axis K is walked in slices of BK:
// each slice of A ([BM, BK]) and of B, stored transposed ([BN, BK], k
// contiguous), is staged in shared memory (zeros wherever the operand has no
// element: past M, N or K, or a conv's halo), then each warp multiplies its
// 32 x 32 sub-tile. bf16 operands go through the tensor cores with
// mma.sync.m16n8k16 (f32 accumulation; the products of bf16 values are exact
// in f32); f32 operands through fmaf on the FP32 cores, with the same
// accumulator layout, so one epilogue serves both:
//     acc[i][j][e]: row 16 i + g + 8 (e >> 1), column 8 j + 2 q + (e & 1)
// of the warp's sub-tile, with g = lane / 4 and q = lane % 4.
// Rows of the staged tiles are padded (by 16 bytes) so that the eight rows g
// that a warp reads at once fall in different banks.
//
// This is the simple form: no cp.async or TMA pipeline, no wgmma; several
// blocks per SM hide the latency of the staging.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace tile {

constexpr int THREADS = 256;
constexpr int BM = 128, BN = 64;

template <typename T>
struct Shape {
  static constexpr bool BF16 = std::is_same<T, __nv_bfloat16>::value;
  static constexpr int BK = BF16 ? 64 : 32;        // k per staged slice: 128 bytes a row
  static constexpr int LD = BK + (BF16 ? 8 : 4);   // padded row of a staged tile
  static constexpr int ROW_RUNS = BK / 8;          // runs of 8 along a row
};

using Acc = float[2][4][4];

__device__ __forceinline__ void zero(Acc& acc) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
}

template <typename T>
__device__ __forceinline__ T zero_value() {
  if constexpr (Shape<T>::BF16) return __float2bfloat16(0.f);
  else return 0.f;
}

template <typename T>
__device__ __forceinline__ T from_float(float x) {
  if constexpr (Shape<T>::BF16) return __float2bfloat16(x);
  else return x;
}

// v[e] = p[e * stride] for e < valid, else 0. With vec (stride 1, p 16-byte
// aligned) and a whole run, one or two 16-byte loads.
template <typename T>
__device__ __forceinline__ void load_run(T (&v)[8], const T* p, long long stride, int valid,
                                         bool vec) {
  if (vec && valid >= 8) {
    if constexpr (Shape<T>::BF16) {
      *reinterpret_cast<uint4*>(v) = *reinterpret_cast<const uint4*>(p);
    } else {
      *reinterpret_cast<float4*>(v) = *reinterpret_cast<const float4*>(p);
      *reinterpret_cast<float4*>(v + 4) = *reinterpret_cast<const float4*>(p + 4);
    }
    return;
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] = e < valid ? p[e * stride] : zero_value<T>();
}

// a run of 8 along a staged row (16-byte aligned: ld and the offset are multiples of 8)
template <typename T>
__device__ __forceinline__ void store_row_run(T* s, const T (&v)[8]) {
  if constexpr (Shape<T>::BF16) {
    *reinterpret_cast<uint4*>(s) = *reinterpret_cast<const uint4*>(v);
  } else {
    *reinterpret_cast<float4*>(s) = *reinterpret_cast<const float4*>(v);
    *reinterpret_cast<float4*>(s + 4) = *reinterpret_cast<const float4*>(v + 4);
  }
}

// Stage a [ROWS, BK] slice: s[r * ld + k] = g[r * rs + k * ks] for r <
// rows_valid and k < k_valid, 0 elsewhere. Runs of 8 go along whichever axis
// has stride 1 in memory, with 16-byte loads where g is 16-byte aligned
// (aligned) and so is every run (the other stride a multiple of 8).
template <typename T, int ROWS>
__device__ __forceinline__ void stage(T* s, int ld, const T* g, long long rs, long long ks,
                                      int rows_valid, int k_valid, bool aligned) {
  constexpr int BK = Shape<T>::BK;
  const int t = threadIdx.x;
  if (ks == 1) {  // runs along k, stored as they are
    const bool vec = aligned && rs % 8 == 0;
    for (int i = t; i < ROWS * BK / 8; i += THREADS) {
      const int r = i / (BK / 8), k8 = (i % (BK / 8)) * 8;
      alignas(16) T v[8];
      const int valid = r < rows_valid ? k_valid - k8 : 0;
      load_run(v, g + r * rs + k8, 1, valid, vec);
      store_row_run(s + r * ld + k8, v);
    }
  } else {  // runs along the rows, scattered into the tile's column k
    const bool vec = aligned && rs == 1 && ks % 8 == 0;
    for (int i = t; i < ROWS * BK / 8; i += THREADS) {
      const int k = i % BK, r8 = (i / BK) * 8;
      alignas(16) T v[8];
      const int valid = k < k_valid ? rows_valid - r8 : 0;
      load_run(v, g + r8 * rs + k * ks, rs, valid, vec);
#pragma unroll
      for (int e = 0; e < 8; ++e) s[(r8 + e) * ld + k] = v[e];
    }
  }
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc += A B over the first kn columns of a staged slice, for one warp's
// 32 x 32 sub-tile: a = &A_s[first row][0], b = &Bt_s[first column][0]. The
// slice is zero past kn up to BK, so bf16 rounds kn up to the mma's 16.
template <typename T>
__device__ __forceinline__ void warp_tile(Acc& acc, const T* a, int lda, const T* b, int ldb,
                                          int kn) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  if constexpr (Shape<T>::BF16) {
    for (int k0 = 0; k0 < kn; k0 += 16) {  // the same steps in every lane: mma.sync is per warp
      const int k = k0 + 2 * q;
      uint32_t af[2][4], bf[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const T* r0 = a + (16 * i + g) * lda + k;
        const T* r8 = r0 + 8 * lda;
        af[i][0] = *reinterpret_cast<const uint32_t*>(r0);
        af[i][1] = *reinterpret_cast<const uint32_t*>(r8);
        af[i][2] = *reinterpret_cast<const uint32_t*>(r0 + 8);
        af[i][3] = *reinterpret_cast<const uint32_t*>(r8 + 8);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const T* c0 = b + (8 * j + g) * ldb + k;
        bf[j][0] = *reinterpret_cast<const uint32_t*>(c0);
        bf[j][1] = *reinterpret_cast<const uint32_t*>(c0 + 8);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(acc[i][j], af[i], bf[j]);
    }
  } else {
    for (int k = 0; k < kn; ++k) {
      float av[2][2], bv[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        av[i][0] = a[(16 * i + g) * lda + k];
        av[i][1] = a[(16 * i + g + 8) * lda + k];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        bv[j][0] = b[(8 * j + 2 * q) * ldb + k];
        bv[j][1] = b[(8 * j + 2 * q + 1) * ldb + k];
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[i][j][e] = fmaf(av[i][e >> 1], bv[j][e & 1], acc[i][j][e]);
    }
  }
}

// The warp's place in the block tile, and each accumulator element's row and
// column in it.
struct WarpPos {
  int row0, col0, g, q;
  __device__ __forceinline__ WarpPos() {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    row0 = (warp >> 1) * 32;
    col0 = (warp & 1) * 32;
    g = lane >> 2;
    q = lane & 3;
  }
  __device__ __forceinline__ int row(int i, int e) const { return row0 + 16 * i + g + 8 * (e >> 1); }
  __device__ __forceinline__ int col(int j, int e) const { return col0 + 8 * j + 2 * q + (e & 1); }
};

}  // namespace tile
